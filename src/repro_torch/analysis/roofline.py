"""Hardware constants of the port's card, for the planners.

The JAX package's ``analysis/roofline.py`` holds a TPU's constants and
derives roofline terms from compiled XLA records; the port keeps only
the ``HW`` table its training planner reads
(``analysis/autotune.py::plan_inputs_from_cfg``), with one NVIDIA H100
SXM's figures from NVIDIA's data sheet (dense rates, no sparsity).  The
pod interconnect entries of the reference (its cross-pod bandwidth and
per-message latency) have no counterpart on one card: the planner's
link prior is ``autotune.LINK_PRIOR_BPS``, and the streaming runtime
replaces it with measured hops.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB (data sheet): bf16 tensor-core peak, f32 outside
# the tensor cores, HBM3 rate and capacity.  chip_smoke.py times every
# kernel's bound against the same peaks.
HW = {
    "peak_flops_bf16": 989e12,      # FLOP/s
    "peak_flops_f32": 67e12,        # FLOP/s
    "hbm_bw": 3.35e12,              # B/s
    "hbm_bytes": 80e9,              # B
}
