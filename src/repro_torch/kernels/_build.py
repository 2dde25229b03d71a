"""Build and load the port's hand-written CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes); all sources compile at once, in parallel.
The libraries are loaded with ``ctypes``: wrappers pass raw device
pointers (``tensor.data_ptr()``) and PyTorch's current stream, and every
C entry point returns ``cudaGetLastError()`` after its launches, which
``check`` turns into an exception.

Builds go to ``build/torch_kernels/`` at the root of the checkout (listed
in ``.gitignore``; ``REPRO_TORCH_BUILD_DIR`` overrides it), named by a
hash of the source, the ``csrc/`` headers it includes and the flags, so
an edited source or header never loads a stale library; its ``ptxas
-v`` report is kept beside it (``build_report``).
Flags (``nvcc_flags``): ``COMMON_FLAGS`` for every source
(``sm_90a`` only, ``-O3``, no ``--use_fast_math``) and each source's own
``SOURCE_FLAGS``: the BM25 kernels add ``--fmad=false``, since their
bit-identity with the plain versions needs IEEE ``*``, ``+`` and ``/``
without contraction. The flash-attention kernels, held to a tolerance,
contract freely. A source's target hashes its own flags only, so a change
to one source's flags rebuilds that source alone.

``LAUNCHES`` counts, per kernel op, the times a wrapper launched its
kernel (the CPU path never touches it); ``chip_smoke.py`` zeroes it
before driving the main path and reads it after.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("postings_pack", "bm25_blockmax", "flash_attention",
           "flash_attention_tc")
COMMON_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "--ptxas-options=-v", "-shared", "-Xcompiler", "-fPIC")
SOURCE_FLAGS = {"postings_pack": (), "bm25_blockmax": ("--fmad=false",),
                "flash_attention": (), "flash_attention_tc": ()}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signatures: every entry point returns cudaGetLastError() as an int
SIGNATURES = {
    "postings_pack": {
        "pp_pack": (_P, _P, _P, _L, _P),
        "pp_unpack": (_P, _P, _P, _L, _P),
    },
    "bm25_blockmax": {
        "bm25_blocks": (_P, _P, _P, _P, _P, _P, _P, _F, _F, _P, _P, _P,
                        _P, _L, _P),
        "bm25_midgrid": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F,
                         _I, _I, _P, _P, _P, _P, _P, _L, _P),
        "bm25_compact": (_P, _L, _P, _P, _P, _P, _L, _P, _P, _P, _P, _F,
                         _P, _P, _P, _L, _P),
        "bm25_midgrid_walk": (_P, _P, _P, _P, _P, _I, _P, _L, _P),
    },
    "flash_attention": {
        "flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _F, _F, _I, _P),
    },
    "flash_attention_tc": {
        "flash_attention_tc_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _F, _P),
    },
}

LAUNCHES = {"pack": 0, "unpack": 0, "bm25_blocks": 0,
            "bm25_blocks_midgrid": 0, "bm25_blocks_compact": 0,
            "flash_attention": 0, "flash_attention_tc": 0}

_LIBS: dict = {}
_LOCK = threading.Lock()
BUILD_LOG: dict = {}   # source -> (seconds, ptxas report) of this process


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def nvcc_flags(name: str) -> tuple:
    """The flags ``csrc/<name>.cu`` is compiled with."""
    return COMMON_FLAGS + SOURCE_FLAGS[name]


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for header in re.findall(rb'#include "([^"]+)"', src):
        h.update((CSRC / header.decode()).read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source that has no library yet (one ``nvcc`` each,
    all started together), then load them all. Returns {name: CDLL}."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.parent / f"{target.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            target.with_suffix(".log").write_text(log)
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    libs = {}
    for name in SOURCES:
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def build_report(name: str) -> str:
    """The compiler's report (``ptxas -v``: registers, spills, warnings)
    from the build of ``csrc/<name>.cu``'s current library."""
    return _target(name).with_suffix(".log").read_text()


def lib(name: str):
    """The loaded library for ``csrc/<name>.cu``, building all sources on
    the first call in this process."""
    with _LOCK:
        if not _LIBS:
            _LIBS.update(build_all())
        return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc} launching {what}")


def check_tensor(t, dtype, shape, name: str) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous CUDA tensor
    of ``dtype`` and ``shape`` (the kernels read raw pointers)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"{name}: want contiguous CUDA {dtype} {tuple(shape)}"
                         f", got {t.dtype} {tuple(t.shape)} on {t.device}")


def check_aligned(t, name: str) -> None:
    """Raise unless ``t``'s data starts on a 16-byte boundary: the kernels
    that load 16 bytes a lane need it, and a view may start anywhere."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel loads 16 bytes a lane and "
                         f"needs a 16-byte aligned tensor, got address "
                         f"{t.data_ptr():#x}")


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
