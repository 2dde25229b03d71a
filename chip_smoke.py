#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                     # the full run (2^20 docs)
    python3 chip_smoke.py --docs 65536        # a shorter run

Phases, in order; any failure exits non-zero and prints no ``ok`` line:

1. device   — the card's ``name, power.limit`` (nvidia-smi);
2. build    — compile the hand-written kernels from ``src/repro_torch/
              kernels/csrc`` (one nvcc per source, in parallel); the
              tensor-core flash kernel's SASS must hold HGMMA (wgmma)
              instructions and its D = 256 instantiation must not spill,
              nor may the SIMT flash kernel's D = 256 instantiations (f32
              and bf16), pack, unpack, bm25_blocks (with and without
              partials), compact or any instantiation of the midgrid walk;
3. parity   — each kernel against its plain PyTorch version on the card:
              exactly, pack/unpack on random words at 1, 31, 33, 4096,
              4097 and 2^21 + 3 blocks (the grid-stride tail; past one
              resident grid; the largest codec stream's size) with bw 0, 1
              and 32 blocks, and unpack(pack(x)) == x, also with garbage
              in every dead plane and with bw 33 and 255 headers; a
              misaligned packed or rows view must raise; bm25_blocks with
              and without partials at S in {1, 37, 4096, 65536}, garbage
              in dead planes, partials of -0.0 and below; midgrid at
              every pow2 bucket up to 4096 blocks for k in {1, 10, 32} and
              128 query rows, and past one staged chunk of its walk (S in
              {16384, 32768}, block_rows 1, 8 and 128, rows out of range,
              ubf = inf, theta = 0 or with negative and infinite rows, a
              block skipped only by the carry's floor at 0);
              bm25_blocks_compact at S in {1, 37, 4099, 20011} (the last
              past the resident warps) with bw-0/bw-32 blocks and the rows
              array's last block; and
              both flash kernels within the JAX kernel test's tolerances
              (2e-5 in f32, the SIMT kernel; 2e-2 in bf16) on that test's
              sweep, D in {8, 16, 160}, D 256 over 1100 tokens with a
              300-token window, the SIMT kernel's tile edges in f32
              (lengths 255-769 around its 256-row kv tiles, windows ending
              at and across them, 288 work items), the tensor-core
              kernel's sweep (D in {64, 128, 160, 256}, ragged lengths,
              windows at and across tile edges, softcap 0 and 50, G in
              {1, 2, 8}) and rows with nothing to attend;
4. lm       — the LM path, with the card to itself: ``launch.serve --mode
              lm`` with gemma2-9b at full width and depth (42 layers,
              seeded random fp32 weights), 4 requests of 8192 tokens, 16
              generated; then ``DecodeScheduler`` with 2 slots serving 3
              ragged requests (8192, 4500, 300 tokens). Prefill s, decode
              ms per step, tok/s, peak device memory; the tensor-core
              flash kernel must launch exactly once per layer per prefill,
              the SIMT one never;
5. lm-checks — the kernels against their plain version on the q, k, v
              the prefill gave one local and one global layer (one batch
              row, in bf16 and cast to f32); at full width, prefill over
              t + 1 tokens against prefill over t then one decode step,
              in bf16 and f32, with two planted faults that must exceed
              the limit (the two f32 prefills are the f32 path's counted
              run: 84 SIMT launches); at SMOKE width, the same weights on
              the card and on the CPU. The LM's state is then freed;
6. slice    — the retrieval main path through ``repro_torch.launch.serve``
              with the full ``lucene_envelope`` CONFIG over a corpus with
              ClueWeb09b's law scaled to ``--docs // SLICE_CUT``: index,
              refresh, serve ``--requests`` queries (32 slots, 4 terms,
              k=10), index more, refresh, serve, delete 8 + update 4
              docs, refresh, serve;
7. checks   — pruned == exhaustive bit for bit on the first 32 queries on
              the card, in the tombstone-free and the tombstoned snapshot,
              every pruned id carrying its true score (ids may differ only
              among equal scores); the card's top-k equal the port's CPU
              path on a 2^14-doc index built from the same batch;
8. profile  — where serving time goes: device busy share of 4 served
              batches under ``torch.profiler`` (device-side events only),
              top kernels, and the host functions with the most own time
              under ``cProfile``;
9. durable  — the durable path at ``--docs``: index every batch into an
              ``FSDirectory`` on the local disk with the WAL, apply the
              slice's 8 deletes + 4 updates, ``commit()``; recover with
              ``open_searcher(..., ReaderCache(compact=True))`` and serve
              ``--requests`` queries through the compact layout; hold
              every batch against a dense-layout searcher over the same
              recovered segments and pruned against exhaustive; then
              index one more batch with the WAL and no commit, drop that
              indexer, reopen the directory and check that the WAL
              replays the acked docs and a query batch returns what it
              returned before the drop;
10. timing  — each kernel on the very inputs the paths gave it, at every
              shape it was launched with (blocks; for flash attention
              batch, length and window): held against its plain version
              once more, then its median device time over 21 launches
              queued behind a spin kernel (the host's launch time hidden;
              L2 flushed before each), its plain version's time on the
              same inputs with the host's launch time included (flash
              attention's one batch row after the other), and its bound
              (the bytes its data needs at 3.35 TB/s vs its operations at
              the peak of their type: 67 TFLOP/s f32, 989 TFLOP/s bf16
              dense, the H100 SXM peaks at a 700 W limit; integer bit
              operations are not counted — the table of peaks has no rate
              for them), each averaged over the paths' launches. Flash
              attention's yardstick, on the same inputs and averaged the
              same way: SDPA (causal, GQA, the window as a mask) at
              softcap 0, beside the kernel at softcap 0; beside the
              tensor-core kernel, the SIMT kernel on the same inputs;
              beside midgrid, its walk launch alone on the same inputs
              (its flags equal to the op's) and the walk's ns per step
              of block_rows blocks.

In every counted run (the LM path, the f32 LM prefills, the slice, the
durable path's indexing + recovery + serving and its WAL run) the launch
counts are zeroed just before and read just after, never around a
comparison, and every kernel of the path must have launched.

The durable path runs at ``--docs`` (2^20 by default) and may not be cut;
the in-memory slice runs at ``--docs // SLICE_CUT``: at 2^20 docs each,
the two paths took 726.7-864.8 s together and the script 835.3-1002.9 s
of its 1200 s limit on an NVIDIA H100 80GB HBM3 at a 700.00 W power
limit, and only the earlier path's depth may be cut; with the LM phases
and the slice at 2^19 the script took 916.8 s, so the slice runs at
2^18.

Prints the kernels as one JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Details (ptxas report, every timing,
the profiles) go to ``<--out>/chip_smoke.json``, ``build/chip_smoke/`` by
default. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import json
import os
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12     # dense tensor-core peak
SLICE_CUT = 4               # the in-memory slice runs at --docs // SLICE_CUT


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def _median_ms(fn, n: int = 21, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(sorted(a.elapsed_time(b) for a, b in ev)[n // 2])


_SPIN: dict = {}


def _device_ms(fn, n: int = 21, warm: int = 2) -> float:
    """Median device time of one call of ``fn`` (a kernel's wrapper), each
    call finding the 50 MB L2 cold (a 128 MB buffer is written before
    it, outside its events). The calls queue behind a spin kernel
    (``torch.cuda._sleep``) that keeps the card busy until the host has
    queued all n, so each pair of CUDA events brackets the device work of
    its call alone, not the host's launch time. If the spin ended before
    the last call was queued, the host set the pace: the spin is made 4x
    longer and the calls run again."""
    import torch
    if not _SPIN:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(1 << 24)
        b.record()
        torch.cuda.synchronize()
        _SPIN["cycles_per_ms"] = (1 << 24) / a.elapsed_time(b)
        _SPIN["flush"] = torch.empty(32 << 20, dtype=torch.float32,
                                     device="cuda")
    t0 = time.perf_counter()
    for _ in range(warm):
        _SPIN["flush"].zero_()
        fn()
    spin_ms = 2 * n * (time.perf_counter() - t0) * 1e3 / warm + 1
    torch.cuda.synchronize()
    for _ in range(4):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        spun = torch.cuda.Event()
        torch.cuda._sleep(int(spin_ms * _SPIN["cycles_per_ms"]))
        spun.record()
        for a, b in ev:
            _SPIN["flush"].zero_()
            a.record()
            fn()
            b.record()
        starved = spun.query()
        torch.cuda.synchronize()
        if not starved:
            return float(sorted(a.elapsed_time(b) for a, b in ev)[n // 2])
        spin_ms *= 4
    raise AssertionError("the host never queued the calls ahead of the card")


def _max_abs_err(got, want) -> float:
    import torch
    err = 0.0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        d = (g.to(torch.float64) - w.to(torch.float64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def _exact(name: str, got, want) -> float:
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the plain "
                                 f"version")
    return _max_abs_err(got, want)


def _blocks(rng, S, dev, ref):
    """Random packed (gaps, tfs) blocks as the BM25 kernels take them."""
    import numpy as np
    import torch
    gaps = rng.integers(0, 50, (S, 128)).astype(np.uint32)
    gaps[:, 0] = 0
    tfs = rng.integers(0, 30, (S, 128)).astype(np.uint32)
    tfs[rng.random(S) < 0.05] = 0
    t = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)  # noqa: E731
    pd, bwd = ref.pack_ref(t(gaps))
    pt, bwt = ref.pack_ref(t(tfs))
    first = torch.from_numpy(rng.integers(0, 1 << 20, S).astype(np.int32))
    idf = torch.from_numpy((rng.random(S) * 4).astype(np.float32))
    act = torch.from_numpy((rng.random(S) < 0.85).astype(np.int32))
    return [pd, bwd, first.to(dev), pt, bwt, idf.to(dev), act.to(dev)]


def _refused(name: str, call) -> None:
    """``call`` (a kernel op on a misaligned view) must raise ValueError
    and launch nothing."""
    from repro_torch.kernels import _build
    before = _build.LAUNCHES[name]
    try:
        call()
    except ValueError:
        assert _build.LAUNCHES[name] == before, name
        return
    raise AssertionError(f"{name}: a misaligned view was not refused")


def phase_parity(dev) -> dict:
    """Every kernel vs its plain version on the card, exactly."""
    import numpy as np
    import torch
    from repro_torch.kernels.bm25_blockmax import ops as bops
    from repro_torch.kernels.bm25_blockmax import ref as bref
    from repro_torch.kernels.postings_pack import ops as pops
    from repro_torch.kernels.postings_pack import ref as pref
    rng = np.random.default_rng(0)
    err = {"pack": 0.0, "unpack": 0.0}
    # pack's grid-stride tail (1, 31, 33, 4097), 4096 blocks, and a
    # stream the size of the largest codec stream; blocks 0-2 have bw 0,
    # 32 and 1
    for nb in (1, 31, 33, 4096, 4097, (1 << 21) + 3):
        g = torch.Generator(device=dev).manual_seed(nb)
        words = torch.randint(0, 1 << 32, (nb, 128), dtype=torch.int64,
                              device=dev, generator=g)
        words >>= torch.randint(0, 33, (nb, 1), device=dev, generator=g)
        words[0], words[1:2], words[2:3] = 0, 0xFFFFFFFF, 1
        d = pref.wrap_i32(words)
        del words
        got, want = pops.pack(d), pref.pack_ref(d)
        err["pack"] = max(err["pack"], _exact(f"pack nb={nb}", got, want))
        bw = got[1][:3].cpu().tolist()
        assert bw == [0, 32, 1][:nb], bw
        back = pops.unpack(*got)
        err["unpack"] = max(err["unpack"], _exact(
            f"unpack nb={nb}", [back], [pref.unpack_ref(*want)]))
        assert torch.equal(back, d), f"unpack(pack(x)) != x at nb={nb}"
        # garbage in every dead plane, and bw 33 / 255 headers (a uint8
        # header holds them) on bw-32 blocks: the same values
        packed, bw = got
        dead = torch.arange(32, device=dev)[None, :, None] >= bw[:, None,
                                                                 None]
        junk = torch.randint(1, 1 << 31, packed.shape, dtype=torch.int32,
                             device=dev, generator=g)
        packed = torch.where(dead, junk, packed)
        del dead, junk
        bw = torch.where(bw == 32, torch.where(torch.arange(
            nb, device=dev) % 2 == 0, 33, 255), bw).to(torch.int32)
        back = pops.unpack(packed, bw)
        err["unpack"] = max(err["unpack"], _exact(
            f"unpack nb={nb} with garbage", [back],
            [pref.unpack_ref(packed, bw)]))
        assert torch.equal(back, d), f"garbage leaked into unpack at nb={nb}"
        del d, got, want, back, packed, bw
    # a misaligned view is refused, not copied or run on the plain path
    buf = torch.zeros(37 * 128 + 1, dtype=torch.int32, device=dev)
    bw = torch.zeros(37, dtype=torch.int32, device=dev)
    _refused("unpack", lambda: pops.unpack(buf[1:].view(37, 32, 4), bw))

    # bm25_blocks past one resident grid (65,536 blocks), with garbage in
    # every dead plane from 37 blocks up (the kernel reads live planes
    # only); partials whose every value is -0.0 or below come out +0.0
    e = 0.0
    g = torch.Generator(device=dev).manual_seed(7)
    for S in (1, 37, 4096, 65536):
        args = _blocks(rng, S, dev, pref)
        for i in (0, 3) if S >= 37 else ():
            dead = torch.arange(32, device=dev)[None, :, None] \
                >= args[i + 1][:, None, None]
            junk = torch.randint(1, 1 << 31, args[i].shape, dtype=torch.int32,
                                 device=dev, generator=g)
            args[i] = torch.where(dead, junk, args[i])
            del dead, junk
        e = max(e, _exact(f"bm25_blocks S={S}", bops.bm25_blocks(*args),
                          bref.bm25_blocks_ref(*args)))
        e = max(e, _exact(f"bm25_blocks partials S={S}",
                          bops.bm25_blocks_partials(*args),
                          bref.bm25_blocks_partials_ref(*args)))
    args = _blocks(rng, 37, dev, pref)
    args[5] = torch.where(torch.arange(37, device=dev) % 2 == 0,
                          torch.tensor(-0.0, device=dev),
                          torch.tensor(-1.5, device=dev))
    args[6] = torch.ones(37, dtype=torch.int32, device=dev)
    got = bops.bm25_blocks_partials(*args)
    e = max(e, _exact("bm25_blocks partials at -0.0", got,
                      bref.bm25_blocks_partials_ref(*args)))
    assert bool((got[3].view(torch.int32) == 0).all()), got[3]
    err["bm25_blocks"] = e
    buf = torch.zeros(37 * 128 + 1, dtype=torch.int32, device=dev)
    _refused("bm25_blocks", lambda: bops.bm25_blocks(
        buf[1:].view(37, 32, 4), *args[1:]))

    e, skipped = 0.0, 0
    for S in [8 << i for i in range(10)]:           # 8 .. 4096
        for k in (1, 10, 32):
            args = _blocks(rng, S, dev, pref)
            rows = torch.from_numpy(rng.integers(0, 128, S).astype(
                np.int32)).to(dev)
            ubf = (rng.random(S) * 8).astype(np.float32)
            ubf[rng.random(S) < 0.05] = np.inf
            ubf = torch.from_numpy(ubf).to(dev)
            theta = torch.from_numpy(rng.random((1, 128)).astype(
                np.float32)).to(dev)
            nmax = torch.tensor(1.2, dtype=torch.float32, device=dev)
            got = bops.bm25_blocks_midgrid(*args, rows, ubf, theta, nmax,
                                           k=k, block_rows=8)
            want = bref.bm25_blocks_midgrid_ref(*args, rows, ubf, theta,
                                                nmax, k=k, block_rows=8)
            e = max(e, _exact(f"midgrid S={S} k={k}", got, want))
            skipped += int(got[3].sum())
    # past one staged chunk of the walk (4096 blocks), 1 to 4 blocks per
    # lane per step; rows out of range, ubf = inf, theta = 0 (S = 16384)
    # or random with -1.5, -0.0, inf and 0 in rows 0-3 (S = 32768), and a
    # negative bound in row 0 right after the first step (skipped only
    # once the carry is floored at 0)
    for S in (16384, 32768):
        for br in (1, 8, 128):
            args = _blocks(rng, S, dev, pref)
            rows = rng.integers(0, 128, S).astype(np.int32)
            edge = rng.random(S) < 0.05
            rows[edge] = rng.choice(np.array([-1, 128, 1000, -(2 ** 31)],
                                             np.int32), int(edge.sum()))
            ubf = (rng.random(S) * 8).astype(np.float32)
            ubf[rng.random(S) < 0.05] = np.inf
            theta = np.zeros((1, 128), np.float32)
            if S == 32768:
                theta = rng.random((1, 128)).astype(np.float32)
                theta[0, :4] = (-1.5, -0.0, np.inf, 0.0)
            rows[:br][rows[:br] == 0] = 5
            rows[br], ubf[br] = 0, -0.5
            args[6][br] = 1
            t = [torch.from_numpy(a).to(dev) for a in (rows, ubf, theta)]
            nmax = torch.tensor(1.2, dtype=torch.float32, device=dev)
            got = bops.bm25_blocks_midgrid(*args, *t, nmax, k=10,
                                           block_rows=br)
            want = bref.bm25_blocks_midgrid_ref(*args, *t, nmax, k=10,
                                                block_rows=br)
            e = max(e, _exact(f"midgrid S={S} block_rows={br}", got, want))
            skipped += int(got[3].sum())
            assert int(got[3][br]) == 1, "the floored carry did not skip"
    assert skipped > 0, "the midgrid carry never skipped a block"
    err["bm25_blocks_midgrid"] = e

    # compact rows of 4099 random blocks (bw 0 and 32 among them); the
    # selections include block 0 (bw 0), block 1 (bw 32) and the last
    # block, whose planes end right before the 32 zero tail rows
    nb = 4099
    rows, coffs, bws = [], [], []
    for lo in (0, 1):
        vals = rng.integers(0, 2 ** 32, (nb, 128), dtype=np.uint64)
        vals >>= rng.integers(0, 33, (nb, 1)).astype(np.uint64)
        vals = vals.astype(np.uint32)
        vals[0], vals[1], vals[-1] = 0, 0xFFFFFFFF, 0x80000000 >> lo
        packed, bw = pref.pack_ref(torch.from_numpy(vals.view(
            np.int32)).to(dev))
        rows.append(torch.cat([pref.compact_planes(packed, bw),
                               torch.zeros((32, 4), dtype=torch.int32,
                                           device=dev)]))
        coffs.append((torch.cumsum(bw, 0) - bw).to(torch.int32))
        bws.append(bw)
    e = 0.0
    for S in (1, 37, 4099, 20011):
        flat = rng.integers(0, nb, S)
        flat[:min(S, 3)] = [nb - 1, 0, 1][:min(S, 3)]
        flat = torch.from_numpy(flat).to(dev)
        first = torch.from_numpy(rng.integers(0, 1 << 31, S).astype(
            np.int32)).to(dev)
        idf = torch.from_numpy((rng.random(S) * 4).astype(np.float32)
                               ).to(dev)
        act = torch.from_numpy((rng.random(S) < 0.85).astype(np.int32)
                               ).to(dev)
        act[0] = 1
        args = (rows[0], coffs[0][flat], bws[0][flat], first, rows[1],
                coffs[1][flat], bws[1][flat], idf, act)
        e = max(e, _exact(f"bm25_blocks_compact S={S}",
                          bops.bm25_blocks_compact(*args),
                          bref.bm25_blocks_compact_ref(*args)))
    err["bm25_blocks_compact"] = e
    buf = torch.zeros(rows[0].numel() + 1, dtype=torch.int32, device=dev)
    buf[1:] = rows[0].reshape(-1)
    _refused("bm25_blocks_compact", lambda: bops.bm25_blocks_compact(
        buf[1:].view(-1, 4), *args[1:]))
    torch.cuda.synchronize()
    return err


FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the JAX kernel test's
LM_ARGV = ["--mode", "lm", "--arch", "gemma2-9b", "--config", "full",
           "--requests", "4", "--prompt-len", "8192", "--gen", "16"]
SCHED_PROMPTS = (8192, 4500, 300)   # ragged requests through 2 slots
SCHED_GEN = 16
LM_FULL_CHECK_LEN = 4500            # past gemma2's 4096-token window
# see phase_lm_checks; on gemma2-9b's random weights on an H100 the sound
# readings were 0.0205 (bf16) and 4.7e-6 (f32), the planted faults
# 0.16-0.22 in both
LM_FULL_CHECK_RMS = {"bfloat16": 0.05, "float32": 1e-4}
LM_SMOKE_TOL = {"float32": 2e-5, "bfloat16": 1.5e-2}


def _flash_err(got, want, what: str) -> float:
    """max |got - want|; raises unless they agree within the JAX kernel
    test's tolerance for their dtype (absolute and relative)."""
    import torch
    tol = FLASH_TOL[str(want.dtype).removeprefix("torch.")]
    g, w = got.to(torch.float32), want.to(torch.float32)
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if got.dtype != want.dtype or got.shape != want.shape \
            or not torch.allclose(g, w, rtol=tol, atol=tol):
        raise AssertionError(f"{what}: the kernel differs from its plain "
                             f"version (max abs err {err}, tolerance {tol})")
    return err


def phase_flash_parity(dev) -> dict:
    """Both flash kernels against their plain version on random inputs,
    each call through the op, which picks the kernel by ``ops.route``:
    1. the JAX kernel test's sweep (``tests/test_kernels_flash.py``: four
       shapes, four window/softcap pairs, non-causal with Sq != Skv) in f32
       and bf16, plus D in {8, 16, 160}, D = 256 over 1100 tokens with a
       window of 300, and rows with nothing to attend; in f32 also the
       SIMT kernel's tile edges (``simt_edges``);
    2. the tensor-core kernel's sweep, bf16: D in {64, 128, 160, 256};
       lengths that are not a multiple of 64 or 128; windows at and
       across the 64- and 128-row tile edges; softcap 0 and 50; G = 1, 2
       and 8; non-causal cross lengths; rows with nothing to attend.
    bf16 at D in {64, 128, 160, 256} must take the tensor-core kernel,
    f32 and bf16 at D in {8, 16} the SIMT one. Returns the max abs error
    per kernel (the SIMT one's per dtype too)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    gen = torch.Generator(device=dev).manual_seed(0)
    jax_sweep = [
        ((1, 128, 128, 4, 4, 64), {}), ((2, 256, 256, 8, 2, 64), {}),
        ((1, 192, 320, 4, 2, 128), {}), ((1, 128, 128, 2, 1, 256), {}),
        *[((1, 128, 128, 4, 2, 64), dict(window=w, softcap=c))
          for w, c in ((0, 0.0), (64, 0.0), (0, 50.0), (32, 30.0))],
        ((1, 64, 96, 2, 2, 64), dict(causal=False)),
        ((2, 100, 100, 4, 2, 8), dict(window=24, softcap=50.0)),
        ((2, 100, 100, 4, 2, 16), dict(window=40)),
        ((2, 300, 300, 4, 2, 160), dict(window=100, softcap=50.0)),
        # gemma2's D, a ragged tail and a window that starts inside a kv
        # tile: the band's tile skipping at its edges
        ((1, 1100, 1100, 4, 2, 256), dict(window=300, softcap=50.0))]
    # the SIMT kernel's tile edges, f32: 64-row q tiles, 256-row kv tiles
    # (lengths 255, 257, 513, 769), windows ending at and across a kv
    # tile, D 8 / 64 / 160 / 256, cross lengths, and 288 work items (more
    # than one per CTA)
    simt_edges = [
        ((1, 255, 255, 2, 1, 256), dict(softcap=50.0)),
        ((1, 257, 257, 2, 2, 256), dict(window=256)),
        ((1, 513, 513, 4, 2, 256), dict(window=257, softcap=50.0)),
        ((2, 320, 700, 2, 1, 160), dict(causal=False)),
        ((1, 769, 769, 4, 1, 8), dict(window=300)),
        ((2, 1100, 1100, 8, 2, 64), dict(window=300, softcap=50.0))]
    # causal, window 4, Sq > Skv: rows 19.. attend to nothing
    empty_rows = dict(window=4)
    tc_sweep = [((B, Sq, Skv, H, KVH, D), kw)
                for D in (64, 128, 160, 256)
                for (B, Sq, Skv, H, KVH), kw in (
                    ((1, 300, 300, 2, 2), dict(window=64)),
                    ((2, 100, 100, 4, 2), dict(softcap=50.0)),
                    ((1, 1100, 1100, 8, 1), dict(window=129, softcap=50.0)),
                    ((1, 257, 257, 4, 4), dict(window=128)),
                    ((1, 700, 700, 8, 1), dict(window=63)),
                    ((1, 192, 320, 4, 2), dict(causal=False, softcap=50.0)),
                    ((1, 64, 16, 2, 1), empty_rows))]
    sweeps = [(torch.float32, jax_sweep + simt_edges
               + [((1, 64, 16, 2, 1, 64), empty_rows)]),
              (torch.bfloat16, jax_sweep + tc_sweep + [((1, 64, 16, 2, 1, 16),
                                                        empty_rows)])]
    err = {"flash_attention_tc": 0.0, "flash_attention/float32": 0.0,
           "flash_attention/bfloat16": 0.0}
    for dtype, cases in sweeps:
        name = str(dtype).removeprefix("torch.")
        for (B, Sq, Skv, H, KVH, D), kw in cases:
            q, k, v = (torch.randn(shape, generator=gen, device=dev
                                   ).to(dtype)
                       for shape in ((B, Sq, H, D), (B, Skv, KVH, D),
                                     (B, Skv, KVH, D)))
            route = fops.route(dtype, D)
            want_tc = dtype == torch.bfloat16 and D in (64, 128, 160, 256)
            if (route == "flash_attention_tc") != want_tc:
                raise AssertionError(f"flash {name} D={D} took {route}")
            got = fops.flash_attention(q, k, v, **kw)
            want = fref.attention_ref(q, k, v, **kw)
            key = route if want_tc else f"{route}/{name}"
            err[key] = max(err[key], _flash_err(
                got, want, f"flash {route} {name} q {tuple(q.shape)} k "
                           f"{tuple(k.shape)} {kw}"))
            if kw is empty_rows and not bool((got[:, 19:] == 0).all()):
                raise AssertionError(f"flash {route} {name} D={D}: a row "
                                     f"with nothing to attend is not 0")
    torch.cuda.synchronize()
    return err


def _ptxas_functions(name: str) -> dict:
    """{mangled function: {"spill_bytes", "registers"}} from the ``ptxas
    -v`` report of ``csrc/<name>.cu``'s current library."""
    import re
    from repro_torch.kernels import _build
    out, cur = {}, None
    for line in _build.build_report(name).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(m[1], {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if cur is not None and m:
            cur["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if cur is not None and m:
            cur["registers"] = int(m[1])
            cur = None
    return out


def tc_build_check() -> dict:
    """The tensor-core kernel's library as built: HGMMA (wgmma) in its
    SASS (``cuobjdump --dump-sass``), and each instantiation's spill bytes
    and registers from the ``ptxas -v`` report. Fails without HGMMA or if
    the LM path's instantiation (D = 256, 64-row kv tiles) spills."""
    import re
    import subprocess
    from repro_torch.kernels import _build
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(_build._target("flash_attention_tc"))],
                          capture_output=True, text=True, check=True).stdout
    out = {"hgmma": sass.count("HGMMA"), "instantiations": {}}
    for fn, props in _ptxas_functions("flash_attention_tc").items():
        m = re.search(r"flash_tc_kernelILi(\d+)ELi(\d+)", fn)
        if m:
            out["instantiations"][f"D{m[1]}_BN{m[2]}"] = props
    path = out["instantiations"].get("D256_BN64", {})
    if out["hgmma"] == 0 or path.get("spill_bytes") != 0:
        raise AssertionError(f"flash_attention_tc: no HGMMA in the SASS or "
                             f"the D = 256 instantiation spills: {out}")
    return out


def retrieval_build_check() -> dict:
    """Spill bytes and registers of the redesigned retrieval kernels:
    ``pack_kernel``, ``unpack_kernel``, ``bm25_kernel`` (without and with
    partials), ``bm25_compact_kernel`` and the four
    ``midgrid_walk_kernel`` instantiations (1-4 blocks per lane per
    step). Fails if one is missing or spills."""
    import re
    out = {}
    for src, kern in (("postings_pack", "pack_kernel"),
                      ("postings_pack", "unpack_kernel"),
                      ("bm25_blockmax", "bm25_kernel"),
                      ("bm25_blockmax", "bm25_compact_kernel"),
                      ("bm25_blockmax", "midgrid_walk_kernel")):
        for fn, props in _ptxas_functions(src).items():
            # (pack_kernel is not unpack_kernel: a mangled name's length,
            # not a letter, precedes it)
            m = re.search(r"(?<![A-Za-z_])" + kern + r"(?:IL[ib](\d+)E)?",
                          fn)
            if m:
                out[kern + (f"<{m[1]}>" if m[1] else "")] = props
    want = {"pack_kernel", "unpack_kernel", "bm25_kernel<0>",
            "bm25_kernel<1>", "bm25_compact_kernel"} | {
        f"midgrid_walk_kernel<{n}>" for n in range(1, 5)}
    if set(out) != want or any(p.get("spill_bytes") != 0
                               for p in out.values()):
        raise AssertionError(f"pack / unpack / bm25_blocks / compact / "
                             f"midgrid walk: a kernel is missing from the "
                             f"ptxas report or spills: {out}")
    return out


def simt_build_check() -> dict:
    """Spill bytes and registers of the SIMT flash kernel's instantiations
    (f32 and bf16; kNC 1 for D <= 128, 2 above). Fails if the D = 256
    ones (kNC 2, f32 and bf16) are missing or spill."""
    import re
    out = {}
    for fn, props in _ptxas_functions("flash_attention").items():
        m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d)E", fn)
        if m:
            out[f"{'f32' if m[1] == 'f' else 'bf16'}_NC{m[2]}"] = props
    if any(out.get(k, {}).get("spill_bytes") != 0
           for k in ("f32_NC2", "bf16_NC2")):
        raise AssertionError(f"flash_attention (SIMT): a D = 256 "
                             f"instantiation is missing or spills: {out}")
    return out


def phase_lm(dev, card, rec) -> tuple:
    """The LM serving path at gemma2-9b's full width and depth: ``launch.
    serve --mode lm`` (4 requests of 8192 tokens, 16 generated), then
    ``DecodeScheduler`` with 2 slots serving 3 ragged requests. Launch
    counts are zeroed before and read after both. Returns (report,
    launches, cfg, params)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.serving.scheduler import DecodeScheduler, Request
    torch.cuda.reset_peak_memory_stats(dev)
    with rec:
        _build.reset_launches()
        out = serve.main([*LM_ARGV, "--device", str(dev)])
        gen_launches = _build.LAUNCHES["flash_attention_tc"]
        cfg, params, toks = out["cfg"], out["params"], out["tokens"]
        rep = dict(out["report"])
        rep["generate_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        del out
        rng = np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n),
                        max_new=SCHED_GEN)
                for i, n in enumerate(SCHED_PROMPTS)]
        t0 = time.perf_counter()
        sched = DecodeScheduler(cfg=cfg, params=params, slots=2,
                                max_len=max(SCHED_PROMPTS) + 2 * SCHED_GEN,
                                device=dev)
        for r in reqs:
            sched.submit(r)
        done = sched.run_to_completion()
        torch.cuda.synchronize(dev)
        rep["sched_s"] = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    del sched
    rep["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    rep["sched_tokens"] = sum(len(r.generated) for r in done)
    rep["sched_tok_per_s"] = rep["sched_tokens"] / rep["sched_s"]
    n_layers = cfg.n_layers
    if gen_launches != n_layers:
        raise AssertionError(f"generate's prefill launched the tensor-core "
                             f"flash kernel {gen_launches} times, not once "
                             f"per layer ({n_layers})")
    tc = launches["flash_attention_tc"]
    if tc != n_layers * (1 + len(SCHED_PROMPTS)):
        raise AssertionError(f"the scheduler's prefills launched the "
                             f"tensor-core flash kernel {tc - n_layers} "
                             f"times, not {n_layers} per admitted request")
    if launches["flash_attention"]:
        raise AssertionError(f"the bf16 LM path launched the SIMT flash "
                             f"kernel {launches['flash_attention']} times")
    _require(launches, ("flash_attention_tc",), "the LM path")
    if toks.shape != (4, 16) or not bool(((toks >= 0)
                                          & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned malformed tokens {toks}")
    if sorted(r.rid for r in done) != list(range(len(SCHED_PROMPTS))) \
            or any(len(r.generated) != SCHED_GEN for r in done):
        raise AssertionError("the scheduler did not finish every request "
                             "with its tokens")
    rep["flash_launches_per_prefill"] = gen_launches
    print(f"[lm] on {card}: {cfg.name} at full width ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.param_count():,} fp32 "
          f"params, random weights from seed 0, init {rep['init_s']:.2f}s):"
          f" {rep['requests']} requests x {rep['prompt_len']}-token prompts,"
          f" {rep['gen']} tokens each: prefill "
          f"{rep['prefill_s']:.3f}s, decode {rep['decode_ms_per_step']:.2f} "
          f"ms/step, {rep['tok_per_s']:.2f} tok/s; peak memory "
          f"{rep['generate_peak_gb']:.2f} GB; flash launches per prefill "
          f"{gen_launches}", flush=True)
    print(f"[lm] DecodeScheduler, 2 slots, requests of {SCHED_PROMPTS} "
          f"tokens x {SCHED_GEN}: {rep['sched_tokens']} tokens in "
          f"{rep['sched_s']:.2f}s ({rep['sched_tok_per_s']:.2f} tok/s, "
          f"admission prefills included); peak memory {rep['peak_gb']:.2f} "
          f"GB; launches {launches}", flush=True)
    return rep, launches, cfg, params


def _rms(x) -> float:
    import torch
    return float(torch.sqrt(torch.mean(x.to(torch.float64) ** 2)))


def phase_lm_checks(dev, cfg, params, rec) -> dict:
    """Three checks of the LM path:
    1. the kernels against their plain version on the q, k, v the prefill
       gave one local and one global layer, at one batch row (the plain
       version holds H * S^2 f32 scores): as they came, in bf16 (the
       tensor-core kernel), and cast to f32 (the SIMT kernel), where only
       the order of summation differs (FLASH_TOL);
    2. at full width, the logits of a prefill over t + 1 tokens against a
       prefill over t tokens then one ``decode_step`` (t = 4500, past the
       window), at the config's bf16 and at f32 compute. In bf16 the two
       paths round at other points (other matmul shapes and orders of
       summation) across 42 layers; in f32 only the order of summation
       differs. The two f32 prefills are the f32 LM path's counted run
       (launch counts zeroed before, read after, ``rec`` recording): each
       of their 84 attention calls must take the SIMT kernel. Their
       difference must stay within LM_FULL_CHECK_RMS of the logits' RMS
       and their argmax agree unless the top-2 margin is within twice the
       largest difference. Two planted faults, read on the same cache each
       run, must exceed that limit: decode at ``lengths - 1`` (a wrong
       position and cache slot) and decode with the window off (a wrong
       mask);
    3. at SMOKE width, gemma2, qwen3 and stablelm with the same weights on
       the card and on the CPU: prefill logits and 3 teacher-forced decode
       steps within LM_SMOKE_TOL (the CPU tests' tolerances against the
       JAX package), in f32 and at the configs' bf16."""
    import contextlib
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.convert import lm_params_from_repro
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.models import transformer as TF
    out = {}
    S = int(LM_ARGV[LM_ARGV.index("--prompt-len") + 1])
    for window in (cfg.sliding_window, 0):
        a, kw = rec.args["flash_attention_tc"][(4, S, window)]
        for dtype in (torch.bfloat16, torch.float32):
            row = [t[:1].to(dtype) for t in a]
            name = str(dtype).removeprefix("torch.")
            out[f"path_layer_err_window_{window}_{name}"] = _flash_err(
                fops.flash_attention(*row, **kw),
                fref.attention_ref(*row, **kw),
                f"flash on the prefill's inputs in {name}, window {window}")
            del row
            torch.cuda.empty_cache()

    t = LM_FULL_CHECK_LEN
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, t + 1))
                            ).to(dev)
    lengths = torch.tensor([t], device=dev)
    no_window = dataclasses.replace(cfg, sliding_window=0)
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        counted = dtype == "float32"
        with rec if counted else contextlib.nullcontext():
            _build.reset_launches()
            _, want = TF.prefill(params, toks, c)
            caches, _ = TF.prefill(params, toks[:, :t], c, pad_to=t + 1)
            launches = dict(_build.LAUNCHES)
        if counted:
            out["f32_launches"] = launches
            if launches["flash_attention"] != 2 * cfg.n_layers \
                    or launches["flash_attention_tc"]:
                raise AssertionError(f"the f32 prefills' attention took "
                                     f"other kernels than the SIMT one "
                                     f"once per layer: {launches}")
        # sound first, then the window off (both write slot t alike), then
        # the wrong slot t - 1 last: the three share one cache
        _, got = TF.decode_step(params, caches, lengths, toks[:, t], c)
        planted = {
            "window_off": TF.decode_step(
                params, caches, lengths, toks[:, t],
                dataclasses.replace(no_window, compute_dtype=dtype))[1],
            "position_minus_1": TF.decode_step(
                params, caches, lengths - 1, toks[:, t], c)[1]}
        if dtype == cfg.compute_dtype:
            # where the LM's time goes, at batch 1 (device-side events):
            # one decode step at length t (it rewrites slot t) and one
            # t-token prefill
            def decode():
                TF.decode_step(params, caches, lengths, toks[:, t], cfg)
                torch.cuda.synchronize(dev)

            def prefill():
                TF.prefill(params, toks[:, :t], cfg)
                torch.cuda.synchronize(dev)
            out["profile_decode_b1"] = _device_profile(decode)
            out["profile_prefill_b1"] = _device_profile(prefill)
        del caches
        diff = (got - want).abs()
        top2 = torch.topk(want[0], 2).values
        chk = {"t": t, "max_abs_diff": float(diff.max()),
                "rms_ratio": _rms(got - want) / _rms(want),
                "logits_rms": _rms(want), "argmax_equal":
                    bool(got.argmax(-1) == want.argmax(-1)),
                "top2_margin": float(top2[0] - top2[1]),
                "limit": LM_FULL_CHECK_RMS[dtype],
                "planted_rms_ratio": {k: _rms(v - want) / _rms(want)
                                      for k, v in planted.items()}}
        out[f"full_decode_vs_prefill_{dtype}"] = chk
        if not (chk["rms_ratio"] <= chk["limit"]
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"full width, {dtype}: prefill(t+1) vs "
                                 f"prefill(t) + decode_step: {chk}")
        if not chk["argmax_equal"] \
                and chk["top2_margin"] > 2 * chk["max_abs_diff"]:
            raise AssertionError(f"full width, {dtype}: decode's argmax "
                                 f"differs at a clear margin")
        if min(chk["planted_rms_ratio"].values()) <= chk["limit"]:
            raise AssertionError(f"full width, {dtype}: a planted fault "
                                 f"stays within the limit: {chk}")
        del got, want, planted
        torch.cuda.empty_cache()

    smoke = {}
    for arch in ("gemma2-9b", "qwen3-32b", "stablelm-12b"):
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(get_arch(arch).smoke,
                                    compute_dtype=dtype)
            p_cpu = TF.init_params(c, torch.Generator().manual_seed(0))
            prompts = np.random.default_rng(1).integers(
                1, c.vocab_size, (2, 100))
            prompts[0, 96:] = 0
            res = []
            for d, p in (("cpu", p_cpu),
                         (dev, lm_params_from_repro(p_cpu, dev))):
                pr = torch.from_numpy(prompts).to(d)
                caches, lg = TF.prefill(p, pr, c, pad_to=104)
                lengths = (pr > 0).sum(1)
                steps = [lg.cpu()]
                for i in range(3):
                    last = torch.from_numpy(prompts[:, i + 1]).to(d)
                    caches, lg = TF.decode_step(p, caches, lengths + i, last,
                                                c)
                    steps.append(lg.cpu())
                res.append(torch.stack(steps))
            err = float((res[0] - res[1]).abs().max())
            smoke[f"{arch}/{dtype}"] = err
            if not err <= LM_SMOKE_TOL[dtype]:
                raise AssertionError(f"smoke {arch} {dtype}: card logits "
                                     f"differ from the CPU's by {err}")
    out["smoke_card_vs_cpu_max_abs"] = smoke
    return out


def phase_slice(args, dev, rec):
    """The retrieval main path; returns its snapshots, report and launch
    counts (``rec`` keeps the inputs each kernel was given)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    argv = ["--device", str(dev), "--config", "full", "--docs",
            str(args.docs // SLICE_CUT), "--batch-docs",
            str(args.batch_docs), "--requests", str(args.requests),
            "--slots", "32", "--query-terms", "4", "--topk", "10",
            "--deletes", "8", "--updates", "4"]
    with rec:
        _build.reset_launches()
        phases, report = serve.main(argv)
        launches = dict(_build.LAUNCHES)
    _require(launches, ("pack", "bm25_blocks", "bm25_blocks_midgrid"),
             "the in-memory slice")
    return phases, report, launches


def _require(launches: dict, names, path: str) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{path} never launched {name}: {launches}")


def check_ids_by_true_score(dense, q, v_p, i_p, i_d, max_k: int = 4096):
    """Every pruned id carries its true score. The exhaustive top-k', with
    k' doubled until each row's last value lies strictly below the pruned
    k-th value (or is 0: every scoring doc is then in), holds every doc
    that scores at least that value, with its true score; a pruned id
    outside it must score 0. Ids may differ from the exhaustive ones only
    among equal scores. Returns where and how they differ."""
    import numpy as np
    import torch
    k = v_p.shape[1]
    kk = 2 * k
    while True:
        v_t, i_t = dense.search_batched(q, kk)
        last = v_t[:, -1]
        if bool(((last < v_p[:, -1]) | (last == 0)).all()):
            break
        if kk >= max_k:
            raise AssertionError(f"more than {max_k} docs tie at the k-th "
                                 f"score")
        kk *= 2
    bits_p = v_p.view(torch.int32).numpy()
    bits_t = v_t.view(torch.int32).numpy()
    ids_p, ids_t, ids_d = i_p.numpy(), i_t.numpy(), i_d.numpy()
    seg_of = {}
    for si, r in enumerate(dense.readers):
        for d in r.doc_map.cpu().numpy().tolist():
            seg_of[d] = si
    diff_rows = diff_pos = cross_seg = 0
    for b in range(q.shape[0]):
        live = ids_p[b][ids_p[b] >= 0]
        if len(set(live.tolist())) != live.size:
            raise AssertionError(f"query {b}: a doc id repeats in the top-k")
        truth = dict(zip(ids_t[b].tolist(), bits_t[b].tolist()))
        for j, d in enumerate(ids_p[b].tolist()):
            want = truth.get(d, 0)          # outside the top-k': scores 0
            if d >= 0 and want != bits_p[b, j]:
                raise AssertionError(f"query {b}: doc {d} at rank {j} is "
                                     f"returned with a score it does not "
                                     f"have")
        moved = np.nonzero(ids_p[b] != ids_d[b])[0]
        diff_rows += bool(moved.size)
        diff_pos += int(moved.size)
        cross_seg += sum(seg_of.get(int(ids_p[b, j])) !=
                         seg_of.get(int(ids_d[b, j])) for j in moved)
    return {"true_scores": True, "k_prime": kk, "rows_ids_differ": diff_rows,
            "positions_ids_differ": diff_pos,
            "positions_across_segments": cross_seg}


def phase_checks(phases, dev, batch0, k: int = 10) -> dict:
    """pruned == exhaustive on the card; card == CPU path at 2^14 docs."""
    import numpy as np
    import torch
    from repro_torch.configs.lucene_envelope import CONFIG
    from repro_torch.core.indexer import Indexer
    from repro_torch.core.searcher import IndexSearcher
    out = {}
    q = np.stack([r.terms for r in phases["first"][1][:32]]).astype(np.int32)
    for name in ("first", "lifecycle"):
        pruned = phases[name][0]
        dense = IndexSearcher(readers=pruned.readers, prune=False, device=dev)
        v_p, i_p = pruned.search_batched(q, k)
        v_d, i_d = dense.search_batched(q, k)
        if not torch.equal(v_p.view(torch.int32), v_d.view(torch.int32)):
            raise AssertionError(f"{name}: pruned != exhaustive on the card")
        out[f"pruned_eq_exhaustive_{name}"] = True
        assert bool(torch.isfinite(v_p).all()) and v_p.shape == (32, k)
        out[f"ids_{name}"] = check_ids_by_true_score(dense, q, v_p, i_p, i_d)
    res = []
    for d in (dev, torch.device("cpu")):
        ix = Indexer(cfg=CONFIG, device=d)
        ix.index_batch(batch0)
        res.append(ix.refresh().search_batched(q, k))
    (v_g, i_g), (v_c, i_c) = res
    if not torch.equal(v_g.view(torch.int32), v_c.view(torch.int32)):
        raise AssertionError("card top-k != CPU path top-k at 2^14 docs")
    out["card_eq_cpu_values"] = True
    out["card_eq_cpu_ids"] = bool(torch.equal(i_g, i_c))
    out["cpu_index_docs"] = int(batch0.shape[0])
    return out


def _leading(name: str, args, kwargs=None):
    """A kernel call's shape key S: blocks (the compact op's first argument
    is the whole rows array; its blocks are its offsets); for flash
    attention (batch, q length, window)."""
    if name.startswith("flash_attention"):
        return (int(args[0].shape[0]), int(args[0].shape[1]),
                int(kwargs.get("window", 0)))
    return int(args[1 if name == "bm25_blocks_compact" else 0].shape[0])


class ShapeRecorder:
    """Wraps the kernel ops the main paths call, only while a path runs
    (``with rec:``, once per counted run): counts each op's calls by their
    shape key S (blocks; for flash attention batch, length and window) and
    keeps a copy of the first call's arguments at each S, so
    ``phase_timing`` can time every kernel on the inputs the paths gave
    it. Flash attention's calls go under the kernel ``ops.route`` picks
    for them. The launch counts stay the wrappers' own."""

    def __init__(self):
        import collections
        from repro_torch.core import query
        from repro_torch.kernels.postings_pack import ops as pops
        from repro_torch.models import transformer
        self.counts = collections.defaultdict(collections.Counter)
        self.args: dict = collections.defaultdict(dict)
        # (module, attribute, kernel name): where the paths look each op
        # up (the storage codec and the reader build call pops.pack)
        self._sites = [(pops, "pack", "pack"), (pops, "unpack", "unpack"),
                       (query, "bm25_blocks", "bm25_blocks"),
                       (query, "bm25_blocks_midgrid", "bm25_blocks_midgrid"),
                       (query, "bm25_blocks_compact", "bm25_blocks_compact"),
                       (transformer, "flash_attention", "flash")]
        self._orig = [getattr(m, a) for m, a, _ in self._sites]

    def _wrap(self, fn, site):
        import torch
        from repro_torch.kernels.flash_attention.ops import route

        def recorded(*args, **kwargs):
            name = site if site != "flash" else route(args[0].dtype,
                                                      args[0].shape[-1])
            S = _leading(name, args, kwargs)
            self.counts[name][S] += 1
            if S not in self.args[name]:
                self.args[name][S] = (
                    tuple(a.clone() if torch.is_tensor(a) else a
                          for a in args), dict(kwargs))
            return fn(*args, **kwargs)
        return recorded

    def __enter__(self):
        for (m, a, name), fn in zip(self._sites, self._orig):
            setattr(m, a, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for (m, a, _), fn in zip(self._sites, self._orig):
            setattr(m, a, fn)
        return False


def _index_bytes(readers) -> int:
    """Device bytes of the readers' block-max indexes (every tensor)."""
    import dataclasses
    import torch
    return sum(v.numel() * v.element_size() for r in readers
               for v in (getattr(r.index, f.name)
                         for f in dataclasses.fields(r.index))
               if torch.is_tensor(v))


def _served_batches(done, slots: int):
    """The served requests in rid order, as (queries, scores, ids) per
    scheduler batch of ``slots``."""
    import numpy as np
    import torch
    done = sorted(done, key=lambda r: r.rid)
    for s in range(0, len(done), slots):
        chunk = done[s:s + slots]
        yield (np.stack([r.terms for r in chunk]).astype(np.int32),
               torch.stack([torch.as_tensor(r.scores) for r in chunk]),
               torch.stack([torch.as_tensor(r.doc_ids) for r in chunk]))


def phase_durable(args, dev, card, rec, del_ids, upd_ids,
                  k: int = 10) -> tuple:
    """The durable path (phase 7 of the module docstring). Returns its
    report and the launch counts of its two counted runs, summed."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs.lucene_envelope import CONFIG
    from repro_torch.core.indexer import Indexer
    from repro_torch.core.searcher import IndexSearcher, ReaderCache
    from repro_torch.data.corpus import CW09B_SMALL, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.serving.query_scheduler import (QueryRequest,
                                                     QueryScheduler)
    from repro_torch.storage import FSDirectory, open_searcher

    def sync():
        torch.cuda.synchronize(dev)

    spec = dataclasses.replace(CW09B_SMALL, n_docs=args.docs)
    corpus = SyntheticCorpus(spec, doc_buffer_len=CONFIG.doc_len)
    n_batches = max(args.docs // args.batch_docs, 2)
    rep = {"docs": n_batches * args.batch_docs}
    t0 = time.perf_counter()
    batches = serve.generate_batches(corpus, n_batches + 1, args.batch_docs)
    rep["generate_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    vocab = np.unique(batches[0][:32])[1:]
    reqs = [QueryRequest(rid=i, terms=rng.choice(vocab, size=4,
                                                 replace=False), k=k)
            for i in range(-32, args.requests)]
    warm, reqs = reqs[:32], reqs[32:]
    # the index lives on the machine's local disk inside the checkout's
    # build/ tree (gitignored), apart from --out, and is removed at the end
    tmp = ROOT / "build" / f"chip_smoke_durable_{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        # --- counted run 1: index + commit, recover, serve -------------
        _build.reset_launches()
        with rec:
            ix = Indexer(cfg=CONFIG, device=dev, wal=True,
                         target_dir=FSDirectory(str(tmp)))
            t0 = time.perf_counter()
            for b in batches[:n_batches]:
                ix.index_batch(b)
            ix.delete(del_ids)
            for d in upd_ids:
                d = int(d)
                ix.update(d, batches[d % n_batches][d % args.batch_docs])
            t1 = time.perf_counter()
            gen = ix.commit()
            sync()
            t2 = time.perf_counter()
            codec = dict(_build.LAUNCHES)
            rep.update(index_s=t1 - t0, commit_s=t2 - t1,
                       docs_per_s=rep["docs"] / (t2 - t0), gen=gen,
                       bytes_by_suffix=ix.store.encoded_bytes_by_suffix(
                           ix.merger.live_segments()),
                       bytes_written=ix.store.bytes_encoded_written,
                       codec_pack_launches=codec["pack"])
            t0 = time.perf_counter()
            gen_r, searcher = open_searcher(
                FSDirectory(str(tmp)), ReaderCache(compact=True, device=dev))
            sync()
            rep["recover_s"] = time.perf_counter() - t0
            rep["codec_unpack_launches"] = _build.LAUNCHES["unpack"]
            if gen_r != gen or not all(r.index.compact
                                       for r in searcher.readers):
                raise AssertionError("recovery did not serve the commit "
                                     "through the compact layout")
            sched = QueryScheduler(searcher=searcher, slots=32, max_terms=4,
                                   k=k, device=dev)
            for r in warm:
                sched.submit(r)
            sched.step()
            t0 = time.perf_counter()
            done, lat = serve._serve(sched, reqs, dev)
            dt = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
        print(f"[durable] on {card}: {rep['docs']} docs to durable at "
              f"{rep['docs_per_s']:.0f} docs/s (index {rep['index_s']:.2f}s"
              f" + commit {rep['commit_s']:.2f}s; corpus generation "
              f"{rep['generate_s']:.2f}s apart); encoded bytes by suffix "
              f"{rep['bytes_by_suffix']} ({rep['bytes_written']} written in "
              f"all); codec launches: pack {rep['codec_pack_launches']} "
              f"(index + commit), unpack {rep['codec_unpack_launches']} "
              f"(recovery)", flush=True)
        rep.update(qps=len(done) / dt, served=len(done),
                   batch_p50_ms=float(np.percentile(lat, 50)) * 1e3,
                   batch_p99_ms=float(np.percentile(lat, 99)) * 1e3,
                   segments=searcher.n_segments, live_docs=searcher.n_docs)
        print(f"[durable] on {card}: recovered commit {gen} "
              f"({searcher.n_segments} segments, {searcher.n_docs} live "
              f"docs) into the compact layout in {rep['recover_s']:.2f}s; "
              f"served {len(done)} queries at {rep['qps']:.1f} QPS, "
              f"batch-of-32 latency p50 {rep['batch_p50_ms']:.2f} ms p99 "
              f"{rep['batch_p99_ms']:.2f} ms; launches {launches}",
              flush=True)
        _require(launches, ("pack", "unpack", "bm25_blocks_compact"),
                 "the durable path")

        # --- checks (not counted): dense layout, exhaustive ------------
        t0 = time.perf_counter()
        dense = ReaderCache(device=dev).refresh(
            [r.seg for r in searcher.readers])
        exhaustive = IndexSearcher(readers=searcher.readers, prune=False,
                                   device=dev)
        ids_moved, checked, dense_ms = 0, 0, []
        for bi, (q, v_s, i_s) in enumerate(_served_batches(done, 32)):
            t1 = time.perf_counter()
            v_d, i_d = dense.search_batched(q, k)
            sync()
            dense_ms.append((time.perf_counter() - t1) * 1e3)
            if not torch.equal(v_s.view(torch.int32),
                               v_d.view(torch.int32)):
                raise AssertionError(f"batch {bi}: compact values != dense")
            if not bool(torch.isfinite(v_s).all()) or v_s.shape[1] != k:
                raise AssertionError(f"batch {bi}: malformed top-k")
            if not torch.equal(i_s, i_d):
                ids_moved += int((i_s != i_d).sum())
                check_ids_by_true_score(dense, q, v_s, i_s, i_d)
            if bi < 2:
                v_e, i_e = exhaustive.search_batched(q, k)
                if not torch.equal(v_s.view(torch.int32),
                                   v_e.view(torch.int32)):
                    raise AssertionError(f"batch {bi}: pruned != "
                                         f"exhaustive")
                check_ids_by_true_score(exhaustive, q, v_s, i_s, i_e)
            checked += q.shape[0]
        rep.update(compact_eq_dense_queries=checked,
                   dense_batch_p50_ms=float(np.percentile(dense_ms, 50)),
                   ids_differ_positions=ids_moved,
                   pruned_eq_exhaustive_queries=min(checked, 64),
                   compact_index_bytes=_index_bytes(searcher.readers),
                   dense_index_bytes=_index_bytes(dense.readers))
        print(f"[durable] checks: {checked} served queries equal the dense "
              f"layout over the same recovered segments (ids differ at "
              f"{ids_moved} positions, all among equal true scores; the "
              f"dense layout's batch p50 {rep['dense_batch_p50_ms']:.2f} ms "
              f"on {card}); "
              f"pruned == exhaustive on the first 64; device bytes of the "
              f"index: compact {rep['compact_index_bytes']} vs dense "
              f"{rep['dense_index_bytes']} ({time.perf_counter() - t0:.1f}s)"
              , flush=True)
        q0 = next(_served_batches(done, 32))[0]
        del dense, exhaustive, sched, searcher, done

        # --- counted run 2: WAL, drop, reopen, replay --------------------
        _build.reset_launches()
        with rec:
            extra = batches[n_batches]
            ix.index_batch(extra)      # acked: in the WAL and RAM only
            v_b, i_b = ix.refresh().search_batched(q0, k)
            del ix                     # dropped without close()
            t0 = time.perf_counter()
            ix2 = Indexer(cfg=CONFIG, device=dev, wal=True,
                          target_dir=FSDirectory(str(tmp)))
            sync()
            rep["reopen_s"] = time.perf_counter() - t0
            rep["wal_replayed_docs"] = ix2.stats.docs
            v_a, i_a = ix2.refresh().search_batched(q0, k)
            more = dict(_build.LAUNCHES)
        ix2.close()
        if rep["wal_replayed_docs"] != extra.shape[0]:
            raise AssertionError(f"WAL replayed {rep['wal_replayed_docs']} "
                                 f"docs, {extra.shape[0]} were acked")
        if not (torch.equal(v_a.view(torch.int32), v_b.view(torch.int32))
                and torch.equal(i_a, i_b)):
            raise AssertionError("the reopened index answers a query batch "
                                 "differently than before the drop")
        print(f"[durable] WAL: {extra.shape[0]} acked docs, not committed; "
              f"the reopened indexer recovered + replayed "
              f"{rep['wal_replayed_docs']} in {rep['reopen_s']:.2f}s and a "
              f"query batch returns what it returned before the drop; "
              f"launches {more}", flush=True)
        for name, n in more.items():
            launches[name] += n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rep, launches


def _plane_bytes(bw_docs, bw_tf, keep) -> int:
    """Bytes of the bit planes a block needs: bw planes of 4 words each,
    for the kept blocks only."""
    return int(((bw_docs + bw_tf) * keep).sum()) * 16


def _live_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs a head attends: k <= q if causal, q - k < window if
    window > 0."""
    import numpy as np
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(Sq,
                                                                   np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def _work(name, args, kwargs, out):
    """(bytes moved, operations, peak operations/s) that this call's data
    needs: each input read once (planes only up to each block's bit width,
    and only for blocks the kernel scores), each output written once. The
    BM25 and codec kernels' operations are f32 ones (integer bit
    operations not counted); flash attention's are 4 D per live (q, k)
    pair per head, at the peak of its input type (bf16: the tensor cores'
    dense peak; f32: the SIMT pipes')."""
    import torch
    if name.startswith("flash_attention"):
        q, k, v = args[:3]
        B, Sq, H, D = q.shape
        pairs = _live_pairs(Sq, k.shape[1], kwargs.get("causal", True),
                            kwargs.get("window", 0))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 \
            else F32_OPS_PER_S
        return nbytes, 4 * D * pairs * B * H, peak
    S = _leading(name, args)
    if name == "pack":
        return S * 128 * 4 + S * (512 + 4), 0, F32_OPS_PER_S
    if name == "unpack":
        # the live planes (16 B each) and bw in; the (S, 128) words out
        return (int(args[1].to(torch.int64).sum()) * 16 + S * 4 + S * 512,
                0, F32_OPS_PER_S)
    if name == "bm25_blocks_compact":
        # coff/bw/first x2 less one first, idf, active; the live plane
        # rows (16 B each) of the scored blocks; three (S, 128) outputs
        keep = args[8].to(torch.int64)
        nbytes = S * 7 * 4 + _plane_bytes(args[2], args[6], keep) \
            + S * 128 * 12
        return nbytes, int(keep.sum()) * 128 * 2, F32_OPS_PER_S
    act = args[6].to(torch.int64)
    if name == "bm25_blocks":
        keep = act
        meta, ops_per_lane = S * 5 * 4, 2          # idf*(k1+1), *tf
    else:
        keep = act * (out[3] == 0).to(act.dtype)   # scored, not skipped
        meta = S * 7 * 4 + 128 * 4 + 4
        # num, tf + norm_max, num / that; k-1 rounds of max + retire
        ops_per_lane = 4 + 2 * (int(kwargs["k"]) - 1)
    nbytes = meta + _plane_bytes(args[1], args[4], keep) + S * 128 * 12
    if name == "bm25_blocks_midgrid":
        nbytes += S * 4                            # skip flags
    return nbytes, int(keep.sum()) * 128 * ops_per_lane, F32_OPS_PER_S


def phase_timing(rec, launches, err, card: str) -> tuple:
    """Each kernel at every shape key S the main paths gave it, on the
    arguments it was given there: held against its plain version once
    more (exactly; flash attention within its tolerance), then timed: the
    kernel by its device time (``_device_ms``, median of 21 launches),
    the plain version on the same arguments by events around the call
    (median of 3; its host launch time included, as its users pay it;
    flash attention's one batch row after the other, since it holds
    H * S^2 f32 scores per row) and, for flash attention, the SDPA
    yardstick on the same arguments (``_flash_yardstick``). A kernel's
    ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are means over
    the paths' launches (each S weighted by its launch count), so each
    pair is held on the same inputs."""
    from repro_torch.kernels.bm25_blockmax import ops as bops
    from repro_torch.kernels.bm25_blockmax import ref as bref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.postings_pack import ops as pops
    from repro_torch.kernels.postings_pack import ref as pref
    calls = {"pack": (pops.pack, pref.pack_ref),
             "unpack": (pops.unpack, pref.unpack_ref),
             "bm25_blocks": (bops.bm25_blocks,
                             lambda *a, k1, b: bref.bm25_blocks_ref(*a, k1)),
             "bm25_blocks_midgrid": (bops.bm25_blocks_midgrid,
                                     bref.bm25_blocks_midgrid_ref),
             "bm25_blocks_compact": (
                 bops.bm25_blocks_compact,
                 lambda *a, k1: bref.bm25_blocks_compact_ref(*a, k1)),
             "flash_attention_tc": (fops.flash_attention,
                                    _by_row(fref.attention_ref)),
             "flash_attention": (fops.flash_attention,
                                 _by_row(fref.attention_ref))}
    sources = {"pack": ("postings_pack.cu", "postings_pack/kernel.py:56"),
               "unpack": ("postings_pack.cu", "postings_pack/kernel.py:80"),
               "bm25_blocks": ("bm25_blockmax.cu",
                               "bm25_blockmax/kernel.py:250"),
               "bm25_blocks_midgrid": ("bm25_blockmax.cu",
                                       "bm25_blockmax/kernel.py:294"),
               "bm25_blocks_compact": ("bm25_blockmax.cu",
                                       "bm25_blockmax/kernel.py:210"),
               "flash_attention_tc": ("flash_attention_tc.cu",
                                      "flash_attention/kernel.py:74"),
               "flash_attention": ("flash_attention.cu",
                                   "flash_attention/kernel.py:74")}
    line, per_shape = [], {}
    for name, (kern, plain) in calls.items():
        weights = rec.counts[name]
        if sum(weights.values()) != launches[name]:
            raise AssertionError(f"{name}: {sum(weights.values())} calls"
                                 f" recorded, {launches[name]} launches")
        flash = name.startswith("flash_attention")
        rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        if flash:
            tot["library_ms"] = 0.0
        by = {"bytes": 0.0, "operations": 0.0}
        for S in sorted(weights):
            a, kw = rec.args[name][S]
            out = kern(*a, **kw)
            out = list(out) if isinstance(out, (tuple, list)) else [out]
            want = plain(*a, **kw)
            want = list(want) if isinstance(want, (tuple, list)) else [want]
            if flash:
                err[name] = max(err[name], _flash_err(
                    out[0], want[0], f"{name} at {S}"))
            else:
                err[name] = max(err[name], _exact(f"{name} at S={S}", out,
                                                  want))
            nbytes, ops, peak = _work(name, a, kw, out)
            skip = out[3] if name == "bm25_blocks_midgrid" else None
            del out, want
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / peak * 1e3
            row = {"S": S, "launches": weights[S],
                   "ms": _device_ms(lambda: kern(*a, **kw)),
                   "plain_ms": _median_ms(lambda: plain(*a, **kw), n=3,
                                          warm=1),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            if flash:
                row.update(_flash_yardstick(a, kw))
            if name == "bm25_blocks_midgrid":
                steps = S // min(int(kw.get("block_rows", 8)), S)
                row["walk_ms"] = _walk_ms(a, kw, skip)
                row["walk_ns_per_step"] = row["walk_ms"] * 1e6 / steps
            if name == "flash_attention_tc":
                # the SIMT kernel, which took these calls before the
                # tensor-core kernel existed, on the same inputs
                row["simt_ms"] = _device_ms(lambda: fops.launch(
                    "flash_attention", *a, **kw), n=5, warm=1)
            rows.append(row)
            w = weights[S] / sum(weights.values())
            for key in tot:
                tot[key] += w * row[key]
            by[row["bound_by"]] += w * row["bound_ms"]
        per_shape[name] = rows
        src, repl = sources[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{repl}",
            "launches": int(launches[name]), "max_abs_err": err[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": max(by, key=by.get),
            "library_ms": tot.get("library_ms")})
        if flash:
            continue
        loss = sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in rows)
        common = max(rows, key=lambda r: (r["launches"], r["S"]))
        print(f"[timing] on {card}: {name}: {line[-1]['ms']:.4f} ms per "
              f"launch on the path (plain {line[-1]['plain_ms']:.3f} ms, "
              f"bound {line[-1]['bound_ms']:.5f} ms); most frequent "
              f"S={common['S']}"
              f" x{common['launches']}: {common['ms']:.4f} ms; largest "
              f"S={rows[-1]['S']} x{rows[-1]['launches']}: "
              f"{rows[-1]['ms']:.4f} ms; loss launches x (ms - bound) "
              f"{loss:.2f} ms", flush=True)
        # shape by shape (pack from 32k blocks)
        cells = [f"{r['S']} ({r['launches']}: {r['ms']:.4f} / "
                 f"{r['bound_ms']:.4f}"
                 + (f"; walk {r['walk_ns_per_step']:.1f} ns/step"
                    if "walk_ms" in r else "") + ")"
                 for r in rows if name != "pack" or r["S"] >= 1 << 15]
        print(f"[timing] on {card}: {name} per S (launches: ms / bound): "
              + ", ".join(cells), flush=True)
    S = int(LM_ARGV[LM_ARGV.index("--prompt-len") + 1])
    for name in ("flash_attention_tc", "flash_attention"):
        fl = next(e for e in line if e["name"] == name)
        print(f"[timing] on {card}: {name}: {fl['ms']:.3f} ms per launch "
              f"over its {fl['launches']} launches (plain "
              f"{fl['plain_ms']:.3f} ms, "
              f"bound {fl['bound_ms']:.4f} ms, SDPA at softcap 0 "
              f"{fl['library_ms']:.3f} ms; each the mean over the same "
              f"launches, on the same inputs)", flush=True)
        for r in per_shape[name]:
            old = f", SIMT {r['simt_ms']:.3f}" if "simt_ms" in r else ""
            print(f"[timing] {name} at (B, S, window) = {r['S']} x"
                  f"{r['launches']}: {r['ms']:.3f} ms (bound "
                  f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.3f}{old}; at "
                  f"softcap 0 the kernel {r['kernel_softcap0_ms']:.3f} vs "
                  f"SDPA {r['library_ms']:.3f})", flush=True)
    rows = {r["S"]: r for r in per_shape["flash_attention_tc"]}
    if (4, S, 0) not in rows:
        raise AssertionError(f"no tensor-core launch at the prefill's "
                             f"B=4 S={S}")
    return line, per_shape


def _walk_ms(a, kw, want_skip) -> float:
    """Device ms (``_device_ms``) of the midgrid walk alone
    (``bm25_midgrid_walk``: the op's second launch, not counted as a
    launch of the path) on one path call's arguments, with the blocks'
    k-th values from the plain version; its skip flags must equal the
    op's."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.bm25_blockmax import ref as bref
    pd, bwd, first, pt, bwt, idf, act, rows, ubf, theta, nmax = a
    S = pd.shape[0]
    _, tf, num = bref._decode(pd, bwd, first, pt, bwt, idf,
                              kw.get("k1", 0.9))
    kth = bref.midgrid_kth_ref(tf, num, act, nmax, int(kw["k"]))
    skip = torch.empty(S, dtype=torch.int32, device=pd.device)
    lib = _build.lib("bm25_blockmax")

    def walk():
        _build.check(lib.bm25_midgrid_walk(
            act.data_ptr(), rows.data_ptr(), ubf.data_ptr(),
            theta.data_ptr(), kth.data_ptr(),
            min(int(kw.get("block_rows", 8)), S), skip.data_ptr(), S,
            _build.stream_ptr(pd)), "bm25_midgrid_walk")
    walk()
    _exact("the midgrid walk alone", [skip], [want_skip])
    return _device_ms(walk)


def _by_row(plain):
    """The plain flash version over the batch one row after the other
    (it holds H * Sq * Skv f32 scores per row): the same function on the
    same inputs."""
    import torch

    def run(q, k, v, **kw):
        return torch.cat([plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw)
                          for i in range(q.shape[0])])
    return run


def _flash_yardstick(a, kw) -> dict:
    """``F.scaled_dot_product_attention`` on one call's inputs, with
    ``is_causal`` or, for a sliding-window layer, the band as a boolean
    mask, beside the kernel at softcap 0 on the same inputs: the same
    function only at softcap 0 (the port never calls SDPA). The mask and
    the repeated k, v are made outside the timed call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    q, k, v = a
    window = int(kw["window"])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    band = None
    if window:
        # GQA with a mask takes SDPA's math backend; with k, v repeated to
        # the query heads (h reads kv head h // G) a fused one takes it
        i = torch.arange(q.shape[1], device=q.device)
        band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                             < window)
        G = q.shape[2] // k.shape[2]
        kt, vt = kt.repeat_interleave(G, 1), vt.repeat_interleave(G, 1)

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, is_causal=band is None,
            enable_gqa=band is None)

    def kern():
        return fops.flash_attention(q, k, v, causal=True, window=window,
                                    softcap=0.0)
    err = _flash_err(kern(), sdpa().transpose(1, 2),
                     f"kernel vs SDPA at softcap 0, {tuple(q.shape)} "
                     f"window {window}")
    return {"library_ms": _device_ms(sdpa), "kernel_softcap0_ms":
            _device_ms(kern), "max_abs_err_vs_sdpa": err}


def _device_profile(fn) -> dict:
    """``fn`` (ending in a synchronize) run once to warm up, once timed on
    the host's clock, then once under ``torch.profiler``: the wall ms,
    the summed device-side ms (kernels, memcpys, memsets: an ATen op's
    device time is that of the kernels it launched, counted there
    already), the busy share (device ms / unprofiled wall ms) and the top
    device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    t0 = time.perf_counter()
    fn()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    kernels = []
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and dt > 0:
            kernels.append((dt / 1e3, e.key, e.count))
    kernels.sort(reverse=True)
    dev_ms = sum(t for t, _, _ in kernels)
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms if dev_ms else None,
            "top_device_ops": [{"ms": t, "op": n[:80], "count": c}
                               for t, n, c in kernels[:12]]}


def phase_profile(phases, dev, k: int = 10) -> dict:
    """Where serving time goes: 4 batches of 32 queries on the full
    tombstone-free snapshot (``_device_profile``), and the host functions
    with the most own time under ``cProfile``."""
    import numpy as np
    import torch
    searcher = phases["refreshed"][0]
    reqs = phases["first"][1]
    q = np.stack([r.terms for r in reqs[:128]]).astype(np.int32)
    batches = [q[i:i + 32] for i in range(0, len(q), 32)]

    def serve():
        for b in batches:
            searcher.search_batched(b, k)
        torch.cuda.synchronize()

    out = {"batches": len(batches), **_device_profile(serve)}
    # the host side of the same batches: the functions with the most own
    # time (cProfile inflates Python-heavy code; read it as an ordering)
    prof_host = cProfile.Profile()
    prof_host.runcall(serve)
    st = pstats.Stats(prof_host)
    host = sorted(((v[2] * 1e3, v[3] * 1e3,
                    f"{Path(f[0]).name}:{f[1]}:{f[2]}")
                   for f, v in st.stats.items()), reverse=True)
    out["top_host_self_ms"] = [{"self_ms": t, "cum_ms": c, "fn": n}
                               for t, c, n in host[:15]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--docs", type=int, default=1 << 20)
    ap.add_argument("--batch-docs", type=int, default=1 << 14)
    ap.add_argument("--requests", type=int, default=1024)
    ap.add_argument("--out", default="build/chip_smoke",
                    help="directory for chip_smoke.json (relative to the "
                         "checkout)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: this script measures the port on a "
                     "card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        return _fail("run from a checkout of the repository (src/repro_torch "
                     "is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import gpu_name_and_power_limit, resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    card = gpu_name_and_power_limit()
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.lib("postings_pack")
    build_s = time.perf_counter() - t0
    print(f"[build] {len(_build.SOURCES)} sources in {build_s:.1f}s",
          flush=True)
    for name, (secs, log) in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    tc_build = tc_build_check()
    print(f"[build] flash_attention_tc: {tc_build['hgmma']} HGMMA "
          f"instructions in the SASS; spill bytes and registers per "
          f"instantiation {tc_build['instantiations']}", flush=True)
    retrieval_build = retrieval_build_check()
    print(f"[build] pack, unpack, bm25_blocks, compact and the midgrid "
          f"walk: spill bytes and registers {retrieval_build}", flush=True)
    simt_build = simt_build_check()
    print(f"[build] flash_attention (SIMT): spill bytes and registers per "
          f"instantiation {simt_build}", flush=True)

    # f32 matmuls of the LM's reference checks run in full f32 (the
    # defaults, set here so no caller's setting leaks in)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    err = phase_parity(dev)
    print(f"[parity] every retrieval kernel equals its plain version "
          f"exactly ({time.perf_counter() - t0:.1f}s): {err}", flush=True)
    t0 = time.perf_counter()
    flash_err = phase_flash_parity(dev)
    err["flash_attention_tc"] = flash_err["flash_attention_tc"]
    err["flash_attention"] = max(flash_err["flash_attention/float32"],
                                 flash_err["flash_attention/bfloat16"])
    print(f"[parity] both flash kernels equal their plain version within "
          f"{FLASH_TOL} (abs and rel) on the JAX kernel test's sweep, D in "
          f"{{8, 16, 160}}, D 256 over 1100 tokens with window 300, the "
          f"tensor-core sweep (D in {{64, 128, 160, 256}}, ragged lengths, "
          f"windows at and across tile edges, softcap 0 and 50, G in "
          f"{{1, 2, 8}}) and rows with nothing to attend; max abs err "
          f"{flash_err} ({time.perf_counter() - t0:.1f}s)", flush=True)

    # the LM path first, with the card to itself; its state is freed
    # before the retrieval paths
    rec = ShapeRecorder()
    t0 = time.perf_counter()
    lm, lm_launches, cfg, params = phase_lm(dev, card, rec)
    lm["lm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm["checks"] = phase_lm_checks(dev, cfg, params, rec)
    checks_lm = {k: v for k, v in lm["checks"].items()
                 if not k.startswith("profile")}
    print(f"[lm-checks] {checks_lm} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    for name in ("decode", "prefill"):
        pr = lm["checks"][f"profile_{name}_b1"]
        print(f"[lm-profile] on {card}: one {name} at batch 1, length "
              f"{LM_FULL_CHECK_LEN}: wall {pr['wall_ms']:.2f} ms, device "
              f"busy {pr['device_ms']:.2f} ms (share "
              f"{pr['device_busy_share'] or float('nan'):.3f}); top: "
              f"{pr['top_device_ops'][:4]}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phases, report, launches = phase_slice(args, dev, rec)
    report["slice_s"] = time.perf_counter() - t0
    print(f"[slice] {report['docs']} docs, {report['segments1']} segments "
          f"at first refresh; launches {launches} ({report['slice_s']:.1f}s)",
          flush=True)
    print(f"[slice] on {card}: indexed {report['docs_per_s']:.0f} docs/s "
          f"(index {report['index_s']:.2f}s + refreshes "
          f"{report['refresh1_s']:.2f}s/{report['refresh2_s']:.2f}s; "
          f"corpus generation {report['generate_s']:.2f}s apart), "
          f"refresh after deletes {report['refresh3_s']:.3f}s, "
          f"{report['qps']:.1f} QPS, batch-of-32 latency p50 "
          f"{report['batch_p50_ms']:.2f} ms p99 "
          f"{report['batch_p99_ms']:.2f} ms; flush wall "
          f"{report['flush_wall_s']:.1f}s"
          f" (merges {report['merge_wall_s']:.1f}s, {report['n_merges']}), "
          f"{report['segments']} segments at the end", flush=True)

    t0 = time.perf_counter()
    from repro_torch.data.corpus import CW09B_SMALL, SyntheticCorpus
    from repro_torch.configs.lucene_envelope import CONFIG
    batch0 = SyntheticCorpus(CW09B_SMALL, doc_buffer_len=CONFIG.doc_len
                             ).batch(0, 1 << 14)
    checks = phase_checks(phases, dev, batch0)
    print(f"[checks] {checks} ({time.perf_counter() - t0:.1f}s)", flush=True)

    t0 = time.perf_counter()
    prof = phase_profile(phases, dev)
    share = prof["device_busy_share"]
    print(f"[profile] on {card}: {prof['batches']} batches of 32 queries in "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['device_ms']:.1f} ms"
          f" (share {'not measured' if share is None else f'{share:.3f}'}); "
          f"top: {prof['top_device_ops'][:3]} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    print(f"[profile] host self time (cProfile): "
          f"{prof['top_host_self_ms'][:6]}", flush=True)

    # the slice's lifecycle targets (as launch/serve.py picks them), for
    # the durable path; then the slice's snapshots are released
    import numpy as np
    served = np.unique(np.concatenate(
        [r.doc_ids for r in phases["refreshed"][1] if r.doc_ids is not None]))
    served = served[served >= 0]
    del_ids, upd_ids = served[:8], served[8:12]
    del phases
    t0 = time.perf_counter()
    durable, d_launches = phase_durable(args, dev, card, rec, del_ids,
                                        upd_ids)
    durable["durable_s"] = time.perf_counter() - t0
    print(f"[durable] ({durable['durable_s']:.1f}s)", flush=True)
    f32_launches = lm["checks"]["f32_launches"]
    launches = {n: launches[n] + d_launches[n] + lm_launches[n]
                + f32_launches[n] for n in launches}

    t0 = time.perf_counter()
    line, per_shape = phase_timing(rec, launches, err, card)
    print(f"[timing] ({time.perf_counter() - t0:.1f}s)", flush=True)

    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "ptxas": {k: v[1] for k, v in
                                      _build.BUILD_LOG.items()},
        "tc_build": tc_build, "retrieval_build": retrieval_build,
        "simt_build": simt_build,
        "report": report, "checks": checks, "profile": prof,
        "durable": durable, "lm": lm,
        "kernels": line, "kernel_shapes": per_shape,
        "total_s": time.perf_counter() - t_start}, indent=1, default=str))
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
