"""whisper-small [audio] — enc-dec: 12L decoder d_model=768 12H (kv=12)
d_ff=3072 vocab=51865, conv frontend STUB [arXiv:2212.04356].

The stub frontend's output, 1500 frame embeddings [B, 1500, 768], feeds a
12-layer bidirectional encoder (``"enc"`` blocks); the 12 decoder layers
interleave self- and cross-attention (``"xattn"`` blocks).  The vocab of
51865 is padded to 51872 (a multiple of 16): the head is [768, 51872],
and the logits and the loss see the first 51865 columns only.

Skips (``SKIPS``): the decoder context is architecturally 448, so the
500k-token decode shape does not exist for this family.
"""
from repro_torch.configs.base import WHISPER_LONG_SKIP, ArchSpec
from repro_torch.models.config import LMConfig

FULL = LMConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    n_heads=12,
    n_kv=12,
    d_ff=3072,
    vocab=51_865,
    vocab_pad_multiple=16,
    pattern=("xattn",) * 12,
    enc_layers=12,
    enc_seq=1500,
    act="gelu",
    norm="layernorm",
    mlp_gated=False,
    mlp_bias=True,
    qkv_bias=True,
    tie_embeddings=False,
)

SMOKE = LMConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=512,
    pattern=("xattn",) * 2,
    enc_layers=2,
    enc_seq=16,
    act="gelu",
    norm="layernorm",
    mlp_gated=False,
    mlp_bias=True,
    qkv_bias=True,
    dtype="float32",
)

SKIPS = {"long_500k": WHISPER_LONG_SKIP}

SPEC = ArchSpec(name="whisper-small", full=FULL, smoke=SMOKE)
