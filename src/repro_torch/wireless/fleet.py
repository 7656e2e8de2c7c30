"""Heterogeneous UE fleet sampling (paper SIV-A, Table I).

Port of the JAX package's ``wireless/fleet.py``: the same
``np.random.default_rng(seed)`` draws in the same order, so a seed gives
the reference's fleet draw for draw.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.wireless.channel import ChannelParams, ue_rates

# Table I compute constants.
K_UE = 16.0   # FLOPs / cycle, UE
K_BS = 32.0   # FLOPs / cycle, BS
F_BS = 80e9   # BS clock, cycles/s
BS_FLOPS = K_UE * 0 + K_BS * F_BS  # = 2.56 TFLOP/s


@dataclasses.dataclass(frozen=True)
class UE:
    """One user equipment with its compute + radio capability."""

    clock_hz: float           # F_i
    p_tx_dbm: float           # p_i
    distance_m: float         # d_i
    storage_flops: float      # c_i: compute-load proxy for the memory bound (C2)

    @property
    def flops(self) -> float:
        """f_i = K_U * F_i (eq (2))."""
        return K_UE * self.clock_hz


@dataclasses.dataclass(frozen=True)
class Fleet:
    ues: tuple
    channel: ChannelParams

    @property
    def n(self) -> int:
        return len(self.ues)

    @property
    def ue_flops(self) -> np.ndarray:
        return np.array([u.flops for u in self.ues])

    @property
    def bs_flops(self) -> float:
        return BS_FLOPS

    def rates(self):
        """Full-band (uplink, downlink) rates per UE, bit/s."""
        p = np.array([u.p_tx_dbm for u in self.ues])
        d = np.array([u.distance_m for u in self.ues])
        return ue_rates(p, d, self.channel)

    @property
    def storage(self) -> np.ndarray:
        return np.array([u.storage_flops for u in self.ues])


def sample_fleet(n: int, seed: int = 0, channel: ChannelParams | None = None,
                 d_range=(100.0, 500.0), f_range=(1e9, 2e9),
                 p_range=(13.0, 23.0), c_range=(1e9, 2e9)) -> Fleet:
    """Sample ``n`` heterogeneous UEs per Table I.

    Note: the paper's text says clock in [0.5, 1.5] Gcycle/s while Table I
    says [1, 2]; we follow Table I (the table supersedes prose).
    """
    rng = np.random.default_rng(seed)
    ch = channel or ChannelParams()
    ues = tuple(
        UE(
            clock_hz=float(rng.uniform(*f_range)),
            p_tx_dbm=float(rng.uniform(*p_range)),
            distance_m=float(rng.uniform(*d_range)),
            storage_flops=float(rng.uniform(*c_range)),
        )
        for _ in range(n)
    )
    return Fleet(ues=ues, channel=ch)
