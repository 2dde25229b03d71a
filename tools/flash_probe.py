#!/usr/bin/env python3
"""Split the f32 SIMT flash-attention kernel's time into phases, on a card.

    python3 tools/flash_probe.py                       # csrc/flash_attention.cu
    python3 tools/flash_probe.py --source OTHER.cu     # another version
    python3 tools/flash_probe.py --out chiprun_out     # where the JSON goes

The kernel source has ``PROBE_MARK(i)`` hooks that compile to nothing in
the port's build. Built here with ``-DFLASH_PROBE``, thread 0 of each CTA
adds the ``clock64()`` cycles since its previous mark to phase i, and the
CTAs' sums land in device counters that ``flash_probe_read`` returns.
Phases: 0 waiting for a copy (and its barrier), 1 q.k^T, 2 the softmax
(and, in a design that has one, the weights' barrier), 3 p.v, 4 issuing
the next copies, 5 the rest (set-up, epilogue, work-item fetch). Thread
0's view includes its waits at barriers, so a phase also holds the time
other warps take to reach the barrier that ends it.

Runs gemma2-9b's f32 check shape (B=1, S=4500, H=16, KVH=8, D=256,
softcap 50) on the global layer and the 4096-token window, and prints per
layer: the share of each phase, the cycles per 64 x 64 tile of (q, kv)
pairs the kernel walked (thread 0's cycles over all CTAs / such tiles,
comparable across tile sizes), the device ms of
the port's build and of the probe build (median of 5, by CUDA events), and
the max abs error of both against the plain version. Needs nvcc and a
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("copy_wait", "qk", "softmax", "pv", "copy_issue", "rest")
B, S, H, KVH, D, SOFTCAP = 1, 4500, 16, 8, 256, 50.0


def _build(source: Path, out: Path, probe: bool):
    from repro_torch.kernels import _build as kb
    flags = list(kb.nvcc_flags("flash_attention"))
    if probe:
        flags.append("-DFLASH_PROBE")
    return subprocess.Popen([kb._nvcc(), *flags, "-o", str(out),
                             str(source)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _load(path: Path, probe: bool):
    from repro_torch.kernels import _build as kb
    lib = ctypes.CDLL(str(path))
    f = lib.flash_attention_fwd
    f.argtypes = list(kb.SIGNATURES["flash_attention"]
                      ["flash_attention_fwd"])
    f.restype = ctypes.c_int
    if probe:
        lib.flash_probe_read.argtypes = [ctypes.c_void_p]
        lib.flash_probe_read.restype = ctypes.c_int
    return lib


def _ms(fn, n: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in ev)[n // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default=str(
        ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"))
    ap.add_argument("--out", default="build/flash_probe")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import gpu_name_and_power_limit
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels import _build as kb
    source = Path(args.source).resolve()
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    procs = {probe: _build(source, out_dir / f"{source.stem}-{probe}.so",
                           probe) for probe in (False, True)}
    report = {}
    for probe, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        report[f"ptxas_probe_{probe}"] = [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
        libs[probe] = _load(out_dir / f"{source.stem}-{probe}.so", probe)
    card = gpu_name_and_power_limit()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    report.update(card=card, clocks=clocks.strip(), source=str(source))
    print(f"[probe] {card}; clocks (sm, max sm) {clocks.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, S, H, D), generator=gen, device="cuda")
    k = torch.randn((B, S, KVH, D), generator=gen, device="cuda")
    v = torch.randn((B, S, KVH, D), generator=gen, device="cuda")
    stream = kb.stream_ptr(q)
    for window in (0, 4096):
        want = ref.attention_ref(q, k, v, causal=True, window=window,
                                 softcap=SOFTCAP)
        row = {}
        for probe, lib in libs.items():
            out = torch.empty_like(q)
            counter = torch.zeros(1, dtype=torch.int32, device="cuda")

            def call():
                counter.zero_()
                kb.check(lib.flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    counter.data_ptr(), B, S, S, H, KVH, D, 1, window,
                    SOFTCAP, 1.0 / math.sqrt(D), 0, stream), "flash probe")
            row[f"ms_probe_{probe}"] = _ms(call)
            row[f"err_probe_{probe}"] = float((out - want).abs().max())
            if probe:
                counters = (ctypes.c_ulonglong * 8)()
                kb.check(lib.flash_probe_read(counters), "probe reset")
                call()
                torch.cuda.synchronize()
                kb.check(lib.flash_probe_read(counters), "probe read")
                cyc = [int(c) for c in counters]
                total = sum(cyc[:6])
                row["ctas"] = cyc[6]
                row["kv_tiles"] = cyc[7]
                row["cycles"] = dict(zip(PHASES, cyc[:6]))
                row["share"] = {p: c / total for p, c in
                                zip(PHASES, cyc[:6])}
                if cyc[7]:
                    row["cycles_per_kv_tile"] = total / cyc[7]
        report[f"window_{window}"] = row
        print(f"[probe] window {window}: ms {row['ms_probe_False']:.3f} "
              f"(probe build {row['ms_probe_True']:.3f}), err "
              f"{row['err_probe_False']:.2e}; ctas {row['ctas']}, kv tiles "
              f"{row['kv_tiles']}, cycles per kv tile "
              f"{row.get('cycles_per_kv_tile', float('nan')):.0f}; share "
              + ", ".join(f"{p} {s:.3f}" for p, s in row["share"].items()),
              flush=True)
        del want
    (out_dir / "flash_probe.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
