"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4, head_dim=128)
d_ff=768 (per expert) vocab=151936, MoE 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B].

The port runs its SMOKE config (split serving of an MoE model with an
untied head); the full config does not fit the port's init on one
80 GB card yet (ROADMAP.md).
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
