"""Architecture registry of the port: ``--arch <id>`` -> (CONFIG, SMOKE).

Only the archs the port serves are here: the dense LMs, the MoE LMs
(moonshot, and llama4 with its early-fusion stub) and the indexing
pipeline. The JAX package's recsys and GNN archs raise ``KeyError``
until their slice is ported (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "qwen3-32b": "qwen3_32b",
    "stablelm-12b": "stablelm_12b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "lucene-envelope": "lucene_envelope",
}
ARCH_IDS = list(_MODULES)


@dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    config: Any
    smoke: Any


def get_arch(arch_id: str) -> ArchEntry:
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP.md, "
                       f"Queue 1); the port has {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return ArchEntry(arch_id, mod.CONFIG, mod.SMOKE)
