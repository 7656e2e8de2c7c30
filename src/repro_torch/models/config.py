"""Architecture configuration for the LM-family model zoo.

A field-for-field copy of the JAX package's ``LMConfig`` (the port keeps
its own copy and imports nothing of that package); a test pins the two
together field by field.
"""
from __future__ import annotations

import dataclasses


def pad_to(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    num_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    family: str = "dense"           # dense | moe | hybrid | ssm | vlm | audio
    head_dim: int | None = None
    qkv_bias: bool = False
    mlp_bias: bool = False          # starcoder2 / whisper style biases
    mlp_gated: bool = True
    act: str = "silu"
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False       # gemma-family sqrt(d) embedding scaling
    logit_softcap: float = 0.0
    # layer pattern: per-layer kind; None => all "attn"
    # kinds: attn | local | rglru | rwkv
    pattern: tuple | None = None
    window: int = 0                 # local attention window
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_capacity: float = 1.25
    # psum router statistics across mesh shards before forming the
    # load-balance aux (kept for field parity; the port has no mesh yet)
    moe_global_aux: bool = False
    # recurrent widths
    lru_width: int | None = None
    conv_width: int = 4
    rwkv_head_dim: int = 64
    rwkv_lora: int = 64
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 0                # stub frontend sequence length (frames)
    # vlm
    num_patches: int = 0            # stub frontend patch tokens
    # vocab padding for sharding (0 = none)
    vocab_pad_multiple: int = 0
    # numerics
    dtype: str = "bfloat16"

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_multiple:
            return pad_to(self.vocab, self.vocab_pad_multiple)
        return self.vocab

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def layer_kinds(self) -> tuple:
        if self.pattern is not None:
            if len(self.pattern) != self.num_layers:
                raise ValueError(
                    f"pattern has {len(self.pattern)} kinds for "
                    f"{self.num_layers} layers")
            return self.pattern
        return ("attn",) * self.num_layers

    @property
    def homogeneous(self) -> bool:
        kinds = self.layer_kinds
        return all(k == kinds[0] for k in kinds)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def r_width(self) -> int:
        return self.lru_width or self.d_model

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.hd
        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds:
            if kind in ("attn", "local"):
                total += d * self.n_heads * hd * 2          # q, o
                total += d * self.n_kv * hd * 2             # k, v
            elif kind == "rglru":
                r = self.r_width
                total += 2 * d * r + r * d + self.conv_width * r + 2 * r * r + 2 * r
            elif kind == "rwkv":
                total += 6 * d * d + 2 * self.rwkv_lora * d
            if kind == "rwkv":
                total += d * f * 2 + d * d                   # channel mix
            elif self.is_moe:
                total += d * self.moe_experts + 3 * self.moe_experts * d * f
            else:
                total += d * f * (3 if self.mlp_gated else 2)
        if self.enc_layers:
            total += self.enc_layers * (4 * d * d + 2 * d * f)
        return int(total)
