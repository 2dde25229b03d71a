"""Architecture registry of the port: ``--arch <id>`` -> (CONFIG, SMOKE).

Only the archs the port serves are here; the JAX package's other archs
(the MoE LMs, recsys and GNN models) raise ``KeyError`` until their
slice is ported (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "qwen3-32b": "qwen3_32b",
    "stablelm-12b": "stablelm_12b",
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
