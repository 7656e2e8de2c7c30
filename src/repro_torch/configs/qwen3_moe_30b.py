"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4, head_dim=128)
d_ff=768 (per expert) vocab=151936, MoE 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B].

The reference's ``LMConfig`` of it, field for field: no q/k norm, which
the reference lacks too.  The port serves it at full width on one 80 GB
card (static, split and continuous): 30.5 B parameters, 61.1 GB in bf16,
whose init fills each stacked leaf in place (``models/blocks.py::
_stacked``).  Training it waits for a sharded path: its f32 master
weights and AdamW's moments alone come to ~366 GB.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import LMConfig

FULL = LMConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    head_dim=128,
    d_ff=768,
    vocab=151_936,
    moe_experts=128,
    moe_topk=8,
    act="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)

SMOKE = LMConfig(
    name="qwen3-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=32,
    d_ff=32,
    vocab=512,
    moe_experts=8,
    moe_topk=2,
    act="silu",
    norm="rmsnorm",
    dtype="float32",
)

SPEC = ArchSpec(name="qwen3-moe-30b-a3b", full=FULL, smoke=SMOKE)
