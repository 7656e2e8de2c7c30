"""Architecture registry plumbing.

Every ported architecture contributes an ``ArchSpec`` with
  * ``full``  — the exact published config (the card's main path),
  * ``smoke`` — a reduced same-family config (CPU tests).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import LMConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    full: LMConfig
    smoke: LMConfig


FULL_ATTN_SKIP = ("long_500k needs sub-quadratic attention; this arch is "
                  "pure full/global attention (DESIGN.md §Shape-skips)")
WHISPER_LONG_SKIP = ("whisper decoder context is architecturally 448; the "
                     "encoder is fixed-length — no 500k variant exists")
