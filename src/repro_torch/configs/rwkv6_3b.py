"""rwkv6-3b [ssm] — "Finch", attention-free: 32L d_model=2560 d_ff=8960
vocab=65536, data-dependent decay WKV [arXiv:2404.05892]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import LMConfig

FULL = LMConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    n_heads=40,              # d_model / rwkv_head_dim
    n_kv=40,
    d_ff=8960,
    vocab=65_536,
    pattern=("rwkv",) * 32,
    rwkv_head_dim=64,
    rwkv_lora=64,
    act="sqrelu",
    norm="layernorm",
)

SMOKE = LMConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=224,
    vocab=512,
    pattern=("rwkv",) * 2,
    rwkv_head_dim=16,
    rwkv_lora=8,
    act="sqrelu",
    norm="layernorm",
    dtype="float32",
)

SPEC = ArchSpec(name="rwkv6-3b", full=FULL, smoke=SMOKE)
