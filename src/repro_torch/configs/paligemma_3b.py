"""paligemma-3b [vlm] — gemma-2b backbone: 18L d_model=2048 8H (GQA kv=1,
head_dim=256) d_ff=16384 vocab=257216 [arXiv:2407.07726].

The SigLIP vision tower is a stub, as in the JAX package: 256 precomputed
patch embeddings [B, 256, d_model] go before the token sequence and are
attended bidirectionally (prefix-LM masking); their labels are -1.

Skips (``SKIPS``): the attention is full and global, so the 500k-token
decode shape needs a sub-quadratic attention this family lacks.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.config import LMConfig

FULL = LMConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv=1,
    head_dim=256,
    d_ff=16384,
    vocab=257_216,
    num_patches=256,
    act="gelu",
    norm="rmsnorm",
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="paligemma-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=1,
    head_dim=16,
    d_ff=256,
    vocab=512,
    num_patches=8,
    act="gelu",
    norm="rmsnorm",
    embed_scale=True,
    tie_embeddings=True,
    dtype="float32",
)

SKIPS = {"long_500k": FULL_ATTN_SKIP}

SPEC = ArchSpec(name="paligemma-3b", full=FULL, smoke=SMOKE)
