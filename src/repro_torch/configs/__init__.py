"""Architecture registry: ``--arch <id>`` resolves through here.

Only the architectures whose path the port runs are registered: the
decoder-only qwen1.5-4b, rwkv6-3b, recurrentgemma-2b, granite-moe-3b-a800m
and qwen3-moe-30b-a3b, the encoder-decoder whisper-small and the
prefix-LM paligemma-3b (stub patch embeddings before the tokens).  The
rest of the JAX package's zoo is listed in ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.configs import (granite_moe_3b, paligemma_3b, qwen3_moe_30b,
                                 qwen15_4b, recurrentgemma_2b, rwkv6_3b,
                                 whisper_small)
from repro_torch.configs.base import ArchSpec

ARCHS = {spec.name: spec for spec in (qwen15_4b.SPEC, rwkv6_3b.SPEC,
                                      recurrentgemma_2b.SPEC,
                                      granite_moe_3b.SPEC,
                                      qwen3_moe_30b.SPEC,
                                      whisper_small.SPEC,
                                      paligemma_3b.SPEC)}


def get_arch(name: str) -> ArchSpec:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
