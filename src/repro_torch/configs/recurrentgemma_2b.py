"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 ratio.

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000 [arXiv:2402.19427].
Griffin layer pattern: (rglru, rglru, local-attn) repeating — one local
attention layer per two recurrent layers; window 2048; tied embeddings.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import LMConfig


def _pattern(n: int) -> tuple:
    base = ("rglru", "rglru", "local")
    return tuple(base[i % 3] for i in range(n))


FULL = LMConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    d_ff=7680,
    vocab=256_000,
    pattern=_pattern(26),
    window=2048,
    lru_width=2560,
    conv_width=4,
    act="gelu",
    norm="rmsnorm",
    embed_scale=True,
    tie_embeddings=True,
    logit_softcap=30.0,
)

SMOKE = LMConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=3,
    d_model=64,
    n_heads=4,
    n_kv=1,
    d_ff=128,
    vocab=512,
    pattern=_pattern(3),
    window=8,
    lru_width=64,
    conv_width=4,
    act="gelu",
    norm="rmsnorm",
    embed_scale=True,
    tie_embeddings=True,
    logit_softcap=30.0,
    dtype="float32",
)

SPEC = ArchSpec(name="recurrentgemma-2b", full=FULL, smoke=SMOKE)
