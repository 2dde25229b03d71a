"""Device resolution for the port's entry points, and the card probe
used for reporting.

Every entry point (``Indexer``, ``ReaderCache``/``IndexSearcher``,
``QueryScheduler``, ``launch.serve``) runs on CUDA unless the caller asks
for the CPU explicitly; with no CUDA device and no explicit ``"cpu"`` it
raises instead of carrying on quietly on the host.
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one);
    ``"cpu"``, ``"cuda"``, ``"cuda:i"`` or a ``torch.device`` after the
    same check. A CUDA device always comes back with its index, so devices
    compare equal to the ones tensors report."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def gpu_name_and_power_limit() -> str:
    """The card's ``name, power.limit`` line as ``nvidia-smi`` reports it
    (the power limit bounds every timing taken on the card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
