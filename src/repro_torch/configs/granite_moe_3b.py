"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8, tied embeddings [hf:ibm-granite family].

d_ff is the per-expert width.  40 experts divide no power-of-two axis;
the port's grouped expert kernel takes any expert count.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import LMConfig

FULL = LMConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv=8,
    d_ff=512,
    vocab=49_155,
    moe_experts=40,
    moe_topk=8,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="granite-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=32,
    vocab=512,
    moe_experts=5,          # deliberately indivisible, like the full config
    moe_topk=2,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    dtype="float32",
)

SPEC = ArchSpec(name="granite-moe-3b-a800m", full=FULL, smoke=SMOKE)
