"""Wireless channel model of the paper (SII-B, Table I).

Port of the JAX package's ``wireless/channel.py``, unchanged: numpy
only, so the same inputs give the same rates and traces.

TDMA cellular system: all UEs share bandwidth ``B``; time is divided into
frames of length ``T`` subdivided into per-UE slots ``tau_i``.  Rates follow
Shannon's theorem under AWGN (eqs (5)-(6)); path loss is the 3GPP-style model
``h(d, f) = 28.0 + 22 log10(d) + 20 log10(f)`` dB used in SIV-A.
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    """System parameters; defaults are the paper's Table I."""

    bandwidth_hz: float = 100e6          # B
    carrier_ghz: float = 3.5             # f (GHz, enters path loss)
    frame_s: float = 10e-3               # T
    p_bs_dbm: float = 46.0               # downlink transmit power
    antenna_gain: float = 10.0           # G (linear)
    noise_psd_dbm_hz: float = -174.0     # N0

    @property
    def noise_w(self) -> float:
        return 10 ** (self.noise_psd_dbm_hz / 10) * 1e-3 * self.bandwidth_hz


def pathloss_db(d_m, f_ghz: float):
    """3GPP UMa-style LOS path loss (paper SIV-A), d in meters, f in GHz."""
    d = np.asarray(d_m, dtype=np.float64)
    return 28.0 + 22.0 * np.log10(d) + 20.0 * np.log10(f_ghz)


def shannon_rate(p_tx_dbm, d_m, ch: ChannelParams):
    """Achievable rate in bit/s over the full band (eqs (5)/(6))."""
    p_w = 10 ** (np.asarray(p_tx_dbm, dtype=np.float64) / 10) * 1e-3
    gain = 10 ** (-pathloss_db(d_m, ch.carrier_ghz) / 10)
    snr = ch.antenna_gain * p_w * gain / ch.noise_w
    return ch.bandwidth_hz * np.log2(1.0 + snr)


def ue_rates(p_ue_dbm, d_m, ch: ChannelParams):
    """(uplink, downlink) full-band rates in bit/s for each UE.

    Uplink uses the UE transmit power, downlink the BS power (eq (6)).
    """
    r_u = shannon_rate(p_ue_dbm, d_m, ch)
    r_d = shannon_rate(ch.p_bs_dbm, d_m, ch)
    return r_u, r_d


# ---------------------------------------------------------------------------
# Scripted link drift (the AC²P²SL premise: the channel is not constant).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BandwidthTrace:
    """Piecewise-constant link bandwidth as a function of training step.

    The deterministic drift driver for the online re-planner's tests and
    the ``replan_drift`` benchmark: ``at(step)`` returns the wire
    bandwidth in BYTES/s in force at that step.  ``steps`` are ascending;
    ``bw_Bps[i]`` applies from ``steps[i]`` (inclusive) until the next
    entry.

    ``steps[0] > 0`` is allowed and has EXPLICIT semantics: ``bw_Bps[0]``
    extends backward over the pre-history ``step < steps[0]`` as well
    (``at`` never has an undefined region).  Consequently ``steps[0]``
    itself is never a point where ``at`` changes value — which is why
    ``change_points`` is defined as "steps where ``at(s) != at(s - 1)``"
    rather than by position in ``steps``.  Construct with
    ``steps[0] == 0`` when you want the trace to spell its initial state
    explicitly; both forms are equivalent and covered by tests.
    """

    steps: tuple
    bw_Bps: tuple

    def __post_init__(self):
        if len(self.steps) != len(self.bw_Bps) or not self.steps:
            raise ValueError(
                f"BandwidthTrace needs matching non-empty steps/bw_Bps, "
                f"got {len(self.steps)} steps / {len(self.bw_Bps)} rates")
        if list(self.steps) != sorted(set(int(s) for s in self.steps)):
            raise ValueError(
                f"BandwidthTrace steps must be strictly ascending, got "
                f"{self.steps}")
        if any(not bw > 0 for bw in self.bw_Bps):
            raise ValueError(f"bandwidths must be > 0, got {self.bw_Bps}")
        object.__setattr__(self, "steps", tuple(int(s) for s in self.steps))
        object.__setattr__(self, "bw_Bps",
                           tuple(float(b) for b in self.bw_Bps))

    def at(self, step: int) -> float:
        """Bandwidth (B/s) in force at ``step``."""
        bw = self.bw_Bps[0]
        for s, b in zip(self.steps, self.bw_Bps):
            if step >= s:
                bw = b
        return bw

    @property
    def change_points(self) -> tuple:
        """Steps at which ``at`` actually changes value.

        Derived from the ``at`` semantics, not from position: ``prev``
        starts at ``bw_Bps[0]`` because that rate is already in force
        before ``steps[0]`` (pre-history extension, class docstring), so
        the first entry only appears here when a LATER entry moves the
        value — the old positional ``out[1:]`` slice encoded the same
        outcome by accident and broke the moment the initial-state and
        first-change entries were conflated.  Duplicate consecutive
        rates never produce a change point.
        """
        out, prev = [], self.bw_Bps[0]
        for s, b in zip(self.steps, self.bw_Bps):
            if b != prev:
                out.append(s)
            prev = b
        return tuple(out)


def bandwidth_step_trace(before_Bps: float, after_Bps: float,
                         at_step: int) -> BandwidthTrace:
    """The canonical drift scenario: one bandwidth step at ``at_step``."""
    return BandwidthTrace(steps=(0, int(at_step)),
                          bw_Bps=(before_Bps, after_Bps))


# ---------------------------------------------------------------------------
# Artificial-delay shaping (loopback socket -> emulated wireless link).
# ---------------------------------------------------------------------------


class LinkShaper:
    """Serialization-delay model for the streaming runtime's loopback
    transport: ``delay_s(nbytes) = latency_s + nbytes / bw_Bps``.

    The streaming runtime (``runtime/``) and split serving
    (``serving/infer.py``) sleep this long before writing each frame, so
    a loopback socket behaves like a link sustaining ``bw_Bps`` — the
    dispatcher's ``LinkEstimator`` then *measures* the emulated channel
    from frame timestamps instead of reading a scripted
    ``BandwidthTrace``.  Deliberately mutable (``set_rate``): tests and
    fleet-churn scenarios re-tune the rate mid-run and assert the
    re-planner notices from measurements alone.  numpy/stdlib only — the
    sleep itself belongs to the caller's event loop.
    """

    def __init__(self, bw_Bps: float, latency_s: float = 0.0):
        self.set_rate(bw_Bps, latency_s)

    def set_rate(self, bw_Bps: float, latency_s: float | None = None):
        if not bw_Bps > 0:
            raise ValueError(f"LinkShaper bw_Bps={bw_Bps} must be > 0")
        if latency_s is not None and latency_s < 0:
            raise ValueError(
                f"LinkShaper latency_s={latency_s} must be >= 0")
        self.bw_Bps = float(bw_Bps)
        if latency_s is not None:
            self.latency_s = float(latency_s)

    def delay_s(self, nbytes: int) -> float:
        return self.latency_s + max(0, int(nbytes)) / self.bw_Bps

    @classmethod
    def from_channel(cls, ch: ChannelParams, p_tx_dbm: float, d_m: float,
                     efficiency: float = 1.0,
                     latency_s: float = 0.0) -> "LinkShaper":
        """Shape the loopback to the Shannon rate (eqs (5)-(6)) of a
        physical-layer configuration; ``efficiency`` derates the bound
        to a deliverable goodput, as in ``shannon_trace``."""
        rate_Bps = float(shannon_rate(p_tx_dbm, d_m, ch)) / 8.0 * efficiency
        return cls(rate_Bps, latency_s)

    def __repr__(self):
        return (f"LinkShaper(bw_Bps={self.bw_Bps:g}, "
                f"latency_s={self.latency_s:g})")


def shannon_trace(ch_by_step, p_tx_dbm: float, d_m: float,
                  efficiency: float = 1.0) -> BandwidthTrace:
    """Channel-model-driven trace: ``{step: ChannelParams}`` -> the wire
    bandwidth (BYTES/s) the Shannon rate (eqs (5)-(6)) sustains at each
    change point.  This is how a physical-layer event (bandwidth
    reallocation, a UE moving, interference raising the noise floor)
    becomes the piecewise link model the re-planner tracks; ``efficiency``
    derates the information-theoretic bound to a deliverable goodput.
    """
    steps = sorted(int(s) for s in ch_by_step)
    rates = [float(shannon_rate(p_tx_dbm, d_m, ch_by_step[s])) / 8.0
             * efficiency for s in steps]
    return BandwidthTrace(steps=tuple(steps), bw_Bps=tuple(rates))
