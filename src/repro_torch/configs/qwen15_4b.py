"""qwen1.5-4b [dense] — 40L d_model=2560 20H (kv=20) d_ff=6912
vocab=151936, QKV bias [hf:Qwen/Qwen1.5-4B]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import LMConfig

FULL = LMConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv=20,
    d_ff=6912,
    vocab=151_936,
    qkv_bias=True,
    act="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)

SMOKE = LMConfig(
    name="qwen1.5-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=512,
    qkv_bias=True,
    act="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    dtype="float32",
)

SPEC = ArchSpec(name="qwen1.5-4b", full=FULL, smoke=SMOKE)
