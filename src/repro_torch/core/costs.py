"""Per-layer cost profiles: FLOPs (fwd/bwd) and cut-layer traffic.

Port of the JAX package's ``core/costs.py`` (numpy only).

The paper characterizes a model by, for each candidate cut point ``l``:
  * ``c_j^F`` / ``c_j^B`` — per-sample forward / backward FLOPs of layer j,
  * ``s_l``              — bytes of the cut layer's activation per sample.

``resnet18_profile`` reproduces the paper's Table II exactly.  ``lm_profile``
derives an equivalent profile for any transformer-zoo config so the AO
optimizer and pipeline schedule apply to the assigned architectures too.
"""
from __future__ import annotations

import dataclasses
import numpy as np

BWD_FWD_RATIO = 2.0  # standard c^B ~= 2 c^F


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Cost profile of one model expressed at its candidate cut points."""

    name: str
    layer_names: tuple            # len L
    fwd_flops: np.ndarray         # c_j^F  per sample, len L
    bwd_flops: np.ndarray         # c_j^B  per sample, len L
    act_bytes: np.ndarray         # s_l: activation bytes/sample AFTER layer j
    label_bytes: float = 4.0      # s_0

    @property
    def num_layers(self) -> int:
        return len(self.fwd_flops)

    def ue_fwd(self, l: int) -> float:
        """sum_{j<=l} c_j^F (per sample), cut AFTER layer index l (1-based)."""
        return float(self.fwd_flops[:l].sum())

    def ue_bwd(self, l: int) -> float:
        return float(self.bwd_flops[:l].sum())

    def bs_fwd(self, l: int) -> float:
        return float(self.fwd_flops[l:].sum())

    def bs_bwd(self, l: int) -> float:
        return float(self.bwd_flops[l:].sum())

    def cut_bytes(self, l: int) -> float:
        """s_l in bytes per sample for a cut after layer l."""
        return float(self.act_bytes[l - 1])

    def ue_total(self, l: int) -> float:
        """sum_{j<=l}(c^F + c^B): the LHS coefficient of storage bound C2."""
        return self.ue_fwd(l) + self.ue_bwd(l)


# --- Paper Table II: ResNet-18 adapted to 32x32 CIFAR-10 ------------------
# Layer        Params(M)  FLOPs(MFLOP)  Traffic(MB)
_RESNET18_TABLE = (
    ("conv1", 0.002, 3.802, 0.250),
    ("block1", 0.148, 303.0, 0.250),
    ("block2", 0.526, 269.1, 0.125),
    ("block3", 2.100, 268.8, 0.063),
    ("block4", 8.394, 268.6, 0.031),
    ("avgpool_fc", 0.005, 0.026, 3.81e-05),
)


def resnet18_profile() -> LayerProfile:
    names = tuple(r[0] for r in _RESNET18_TABLE)
    fwd = np.array([r[2] * 1e6 for r in _RESNET18_TABLE])
    traffic = np.array([r[3] * 2 ** 20 for r in _RESNET18_TABLE])
    return LayerProfile(
        name="resnet18_cifar10",
        layer_names=names,
        fwd_flops=fwd,
        bwd_flops=fwd * BWD_FWD_RATIO,
        act_bytes=traffic,
        label_bytes=4.0,
    )


def resnet18_params() -> np.ndarray:
    return np.array([r[1] * 1e6 for r in _RESNET18_TABLE])


def lm_profile(name: str, *, num_layers: int, d_model: int, d_ff: int,
               n_heads: int, n_kv: int, vocab: int, seq_len: int,
               moe_experts: int = 0, moe_topk: int = 0,
               act_dtype_bytes: int = 2) -> LayerProfile:
    """Derive a per-layer cost profile for a decoder LM at a given seq_len.

    "Per sample" here means per sequence.  Candidate cuts sit after the
    embedding and after each transformer block; the head is the last unit.
    """
    head_dim = d_model // max(n_heads, 1)
    # qkvo projections (GQA: kv projections scaled by n_kv/n_heads)
    qo = 2 * 2 * seq_len * d_model * d_model
    kv = 2 * 2 * seq_len * d_model * head_dim * max(n_kv, 1)
    attn_scores = 2 * 2 * seq_len * seq_len * d_model  # QK^T + PV
    if moe_experts and moe_topk:
        mlp = 2 * 3 * seq_len * d_model * d_ff * moe_topk  # gated MLP, top-k experts
    else:
        mlp = 2 * 3 * seq_len * d_model * d_ff
    block = qo + kv + attn_scores + mlp
    embed = 0.0  # gather, negligible FLOPs
    head = 2 * seq_len * d_model * vocab

    names = ("embed",) + tuple(f"block{i}" for i in range(num_layers)) + ("head",)
    fwd = np.array([embed] + [block] * num_layers + [head])
    act = np.full(len(names), seq_len * d_model * act_dtype_bytes, dtype=np.float64)
    act[-1] = 4.0  # after head+loss only a scalar-ish loss remains
    return LayerProfile(
        name=name,
        layer_names=names,
        fwd_flops=fwd,
        bwd_flops=fwd * BWD_FWD_RATIO,
        act_bytes=act,
        label_bytes=seq_len * 4.0,
    )
