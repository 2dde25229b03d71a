#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                     # the full run (2^20 docs)
    python3 chip_smoke.py --docs 65536        # a shorter run

Phases, in order; any failure exits non-zero and prints no ``ok`` line:

1. device   — the card's ``name, power.limit`` (nvidia-smi);
2. build    — compile the hand-written kernels from ``src/repro_torch/
              kernels/csrc`` (one nvcc per source, in parallel); the
              tensor-core flash kernel's SASS must hold HGMMA (wgmma)
              instructions and its instantiations on the LM paths (D = 256
              for gemma2, D = 128 for moonshot) must not spill, nor may the
              SIMT flash kernel's D = 256 instantiations (f32 and bf16),
              pack, unpack, bm25_blocks (with and without partials),
              compact or any instantiation of the midgrid walk;
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
6. moe      — the MoE LM, alone on the card: ``launch.serve --mode lm``
              with moonshot-v1-16b-a3b at full width and depth (48
              layers, 64 experts top-6, 27.72 B params in bf16, seeded
              random weights), 4 requests of 4096 tokens, 16 generated;
              then ``DecodeScheduler`` with 2 slots serving requests of
              4096 and 300 tokens. The gates of [lm] (48 tensor-core
              launches per prefill), plus the share of the prefill's
              assignments dropped past capacity;
7. moe-checks — [lm-checks] for moonshot: the flash kernels on the D = 128
              q, k, v of its prefill; prefill(t + 1) against prefill(t) +
              decode at a dropless capacity factor, on the logits and on
              the MoE layers' outputs, in bf16 and f32 (96 SIMT launches;
              the token's routing may differ between the paths only at a
              near-tie), with planted faults at a wrong position and with
              every assignment sent to the next expert; moonshot and
              llama4 (with patches) at SMOKE width on the card (on the
              CPU's routing) and on the CPU. Its state is then freed;
8. train    — LM training through ``launch.train``'s loop: stablelm-12b
              at its published widths with 8 of its 40 layers (3.25 B
              params; fp32 params, grads and AdamW state, 52.0 GB; 40
              layers would take 194 GB), bf16 compute, 6 steps of 2 x
              4096 tokens (``LMBatches``, seed 0), lr 1e-5. Each step's
              loss and grad norm, the median step, tok/s, the peak device
              memory and the model-FLOP share. Gates: losses and grad
              norms finite, the last step's loss below the first's, and
              the same 6 steps with the gradient's sign flipped fail
              that; no kernel launches (training attends through the
              plain blockwise function, as the JAX training step does).
              Then at 2 layers over one 4096-token sequence the
              bf16-compute gradient against the f32-compute one: the
              largest relative RMS over leaves within TRAIN_GRAD_LIMIT,
              and above it with the causal mask dropped and with the
              queries' rope one position ahead;
9. train-checks — at SMOKE width, the card against the CPU on the same
              weights and batches: stablelm, gemma2 and moonshot over 2
              AdamW steps in f32 and bf16 (losses, grad norms, the
              params' update), 4 microbatches against 1, a run
              checkpointed at step 2 by ``AsyncCheckpointer``, resumed
              and held against the uninterrupted one, and a torn save
              (an in-place update right after ``save_async`` with its
              host copy removed) seen;
10. slice   — the retrieval main path through ``repro_torch.launch.serve``
              with the full ``lucene_envelope`` CONFIG over a corpus with
              ClueWeb09b's law scaled to ``--docs // SLICE_CUT``: index,
              refresh, serve ``--requests`` queries (32 slots, 4 terms,
              k=10), index more, refresh, serve, delete 8 + update 4
              docs, refresh, serve;
11. checks  — pruned == exhaustive bit for bit on the first 32 queries on
              the card, in the tombstone-free and the tombstoned snapshot,
              every pruned id carrying its true score (ids may differ only
              among equal scores); the card's top-k equal the port's CPU
              path on a 2^14-doc index built from the same batch; beside
              it (neither is timed as a metric), ``examples/torch_*.py``
              on the card, each must exit 0;
12. profile — where serving time goes: device busy share of 4 served
              batches under ``torch.profiler`` (device-side events only),
              top kernels, and the host functions with the most own time
              under ``cProfile``;
13. durable — the durable path at ``--docs``: index every batch into an
              ``FSDirectory`` on the local disk with the WAL, apply the
              slice's 8 deletes + 4 updates, ``commit()``; recover with
              ``open_searcher(..., ReaderCache(compact=True))`` and serve
              ``--requests`` queries through the compact layout; hold
              every batch against a dense-layout searcher over the same
              recovered segments and pruned against exhaustive; then
              index one more batch with the WAL and no commit, drop that
              indexer, reopen the directory and check that the WAL
              replays the acked docs and a query batch returns what it
              returned before the drop; its ``envelope_report()``;
14. envelope — the paper's experiment at CONFIG width: per media pair
              (isolated ``nas -> ssd``, two throttles; shared ``ssd ->
              ssd``, one), 1 batch (2^14 docs) spooled into a throttled
              RAM source, ``index_spooled`` into a throttled
              ``FSDirectory``, ``finalize()``, ``envelope_report()``; the
              commit recovered on the card serves 32 queries (pruned ==
              exhaustive). Gates: the measured source bytes are the
              spooled bytes, the encoded bytes are the live segment
              files' bytes, and the isolated pair's measured GB/min
              beats the shared pair's; then ``calibrate()`` refitted with
              both runs;
15. steady  — serving while indexing, open loop: an ``Indexer`` with the
              refresh daemon (1 s) and 2 merge threads, a cached
              ``QueryScheduler`` attached; 4 seed batches (the warm probe
              timed once more, uncached, and its QPS printed), then
              Poisson arrivals at a fixed 75 QPS for 90 s while 36
              batches are ingested and 8 served docs deleted every 4th
              tick, a tick that flushed or deleted ending when the daemon
              has swapped in a new generation. Gates:
              every arrival completed, none shed, >= 10 daemon refreshes
              and served generations, >= 1 merge on 2 threads, and after
              ``close()`` + ``refresh()`` pruned == exhaustive, true
              scores, no deleted doc served, the last generation's cache
              entries == uncached searches. Latency is reported for all
              arrivals and for the cache misses alone;
16. fleet   — the replicated fleet (``repro_torch.replication``): 2 range
              shards x 2 replicas at CONFIG width, 2^13 docs a shard
              committed, then 2^13 more and 8 deletes a shard and a second
              commit; shard 0's replicas are ``ReplicaSyncer``s in this
              process, shard 1's ``RemoteReplica`` processes, each with its
              own CUDA context; first and delta sync (wall, lag, files,
              bytes); 8 closed-loop batches of 32 queries through
              ``FleetSearcher``; a rotted ``.pst`` found by a sweep and
              quarantined (8 degraded batches, none served by it), then
              ``repair``; a rotted ``.doc`` on a replica process healed
              by ``anti_entropy``; 2 batches after each heal. Gates: every
              batch == the union oracle over the shards' commits (values
              bit for bit, ids by true score), no deleted doc served;
              unpack and bm25_blocks or midgrid launched in this process
              and in each replica process;
17. mesh    — the multi-device indexing step (``make_index_step``: invert,
              all-to-all term shuffle over ``model``, pack) at full CONFIG
              width, 4096 docs x 1024 tokens a rank of CW09B_SMALL's law:
              a world of 4 processes on this card over gloo (a (2, 2)
              ``("data", "model")`` mesh, ``file://`` rendezvous, the
              exchange staged through host memory, a bounded wait),
              while this process runs the plain loopback of the same 4
              blocks on the CPU; then world 1 over NCCL in this process
              (a (1, 1) mesh, block 0), held against the plain path on
              the CPU. Each rank's step, its stages and the exchange's
              share, raw and packed2 shuffle bytes, dropped entries.
              Gates: every rank's outputs (run, stats, packed words,
              widths, packed_bytes) == the plain path bit for bit (SHA-256
              digests); packed2 == raw; sent == recv + dropped over the
              world; every term on model index m is m mod 2; pack launched
              in each rank's counted step; ``merge_topk_sharded`` over a
              (4,) and a (1,) ``shard`` mesh == the host merge;
18. timing  — each kernel on the very inputs the paths gave it, at every
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

In every counted run (the two LM paths, their f32 prefills, the slice, the
durable path's indexing + recovery + serving and its WAL run, each
envelope pair's indexing + recovery + serving, steady's whole run, and
the fleet's writers, syncs, serving and heals, and [mesh]'s first step
in each rank and in this process) the launch counts are zeroed just
before and read just after (after every thread the run started has been
joined; a replica or mesh process counts its own and reports them),
never around a comparison, and every kernel of the path must have
launched.

The durable path runs at ``--docs`` (2^20 by default) and may not be cut;
the in-memory slice runs at ``--docs // SLICE_CUT``: at 2^20 docs each,
the two paths took 726.7-864.8 s together and the script 835.3-1002.9 s
of its 1200 s limit on an NVIDIA H100 80GB HBM3 at a 700.00 W power
limit, and only the earlier path's depth may be cut; with the LM phases
and the slice at 2^19 the script took 916.8 s, so the slice ran at
2^18. With [envelope], [steady] and [examples] added the script's own
total was 986.2 s with the slice at 2^18 and 896.9-897.4 s at 2^17 (the
same card), so the slice ran at 2^17. [steady]'s arrivals were once paced at
half the slice's QPS and followed its depth (201.75 offered at 2^18,
603.43 at 2^17); they now come at a fixed 75 QPS. With [fleet] the
script took 1027.7-1125.2 s, and with [mesh] added 1155.2-1212.9 s on
slower hosts before some of the cuts below and 1016.4 s on a fast host
after all of them. To make room: the slice runs at 2^16 (``SLICE_CUT``
16) and [examples] runs beside [checks]. [steady] cannot give time and
keep its gates: its one merge needs all 40 batches (4 seed + 24 ticks
ran none), and 16 seed + 24 ticks took as long as 4 + 36. The time limit
is held as a ratio to the host's own speed: ``total_s`` at most 1.85x
the durable path's seconds (1.89 with [mesh], over the limit on a host
1.19x slower). [moe] and [moe-checks] took 38.9 s, and with them the
script took 992.8 s against a durable path of 531.2 s (1.869), with
[envelope] at 2^15 docs a pair (28.6 s at 2^16, 14.8 s), [fleet] at
2^14 docs a shard (77.2 s at 2^15, 49.5 s) and [timing]'s plain
versions timed once after a warm-up (36.6 s with 3, 30.5 s with
moonshot's shapes added). So [envelope] runs at 2^14 docs a pair, not
2^16 (``ENVELOPE_BATCHES``), [fleet] at 2^14 docs a shard, not 2^15
(``FLEET_BATCHES``), with 8 closed-loop batches, not 16
(``FLEET_SERVE_BATCHES``), [mesh] times 3 steps a payload, not 5
(``MESH_STEPS``), and [timing] times each plain version once.
[train] and [train-checks] took 28.2-28.5 + 3.9-4.5 s and the script
1020.1-1020.4 s against durable paths of 561.1 and 541.7 s (1.818 and
1.884, over the limit on the faster durable path), the train example in
[examples] beside [checks]. So the slice runs at 2^15 (``SLICE_CUT``
32, not 16: 11.3 s at 2^16), [fleet] at 2^13 docs a shard
(``FLEET_BATCH_DOCS``, not 2^14: 47.2-50.8 s), and [timing] takes the
plain version's check call as its warm-up (29.6-29.9 s with a separate
one).

Prints the script's ``total_s``, the kernels as one JSON line, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``. Details
(ptxas report, every timing, the profiles) go to
``<--out>/chip_smoke.json``, ``build/chip_smoke/`` by default. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import cProfile
import gc
import json
import os
import pstats
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12     # dense tensor-core peak
SLICE_CUT = 32              # the in-memory slice runs at --docs // SLICE_CUT


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


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
# the MoE LM at full width and depth, its weights in bf16 (55.4 GB; fp32
# would not fit the card)
MOE_ARGV = ["--mode", "lm", "--arch", "moonshot-v1-16b-a3b", "--config",
            "full", "--param-dtype", "bfloat16", "--requests", "4",
            "--prompt-len", "4096", "--gen", "16"]
MOE_SCHED_PROMPTS = (4096, 300)
LM_FULL_CHECK_LEN = 4500            # past gemma2's 4096-token window
# see phase_lm_checks; on gemma2-9b's random weights on an H100 the sound
# readings were 0.0205 (bf16) and 4.7e-6 (f32), the planted faults
# 0.16-0.22 in both
LM_FULL_CHECK_RMS = {"logits": {"bfloat16": 0.05, "float32": 1e-4}}
# moonshot: the logits' limits as gemma2's, and the same ratio for the
# position-t token's MoE layer outputs, the median over layers (see
# phase_lm_checks)
MOE_FULL_CHECK_RMS = {"logits": {"bfloat16": 0.05, "float32": 1e-4},
                      "moe_layers": {"bfloat16": 0.05, "float32": 1e-4}}
# planted faults a bf16 check may miss: on moonshot's random weights the
# residual stream is the token's own embedding plus small updates, so a
# decode at the wrong position moved its bf16 readings by 0.0073 (logits)
# and 0.0124 (MoE layers) against 0.0062 and 0.0096 for the sound pair
# (H100, run 1 of PR 25); its f32 pair must catch it
BF16_BLIND = {"moonshot-v1-16b-a3b": ("position_minus_1",)}
# the largest router margin (k-th minus (k+1)-th probability) at which a
# token may take other experts in the other run: bf16 rounding of the
# router's input (SMOKE: as tests/test_torch_moe.py; full width: see
# phase_lm_checks)
MOE_ROUTE_TIE = {"smoke": 2 ** -10, "full": 2 ** -8}
LM_SMOKE_TOL = {"float32": 2e-5, "bfloat16": 1.5e-2}
LM_SMOKE_ARCHS = ("gemma2-9b", "qwen3-32b", "stablelm-12b")
MOE_SMOKE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e")

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
    an LM path's instantiation spills or is missing: gemma2's (D = 256,
    64-row kv tiles) and moonshot's (D = 128, 128-row kv tiles)."""
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
    if out["hgmma"] == 0 or any(
            out["instantiations"].get(k, {}).get("spill_bytes") != 0
            for k in ("D256_BN64", "D128_BN128")):
        raise AssertionError(f"flash_attention_tc: no HGMMA in the SASS, or "
                             f"the D = 256 or D = 128 instantiation is "
                             f"missing or spills: {out}")
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


class RouteRecorder:
    """Wraps the model's MoE layer (``transformer.moe_ffn``) while active
    (``with``): per call, in call order, its tokens ``T``, the
    assignments ``dropped`` past capacity, each token's experts (in
    top-k ``order`` and as a sorted set) and its router ``margin`` (k-th
    minus (k+1)-th probability), all from the layer's own ``moe.route`` on
    its input, and the layer's output for the call's last token
    (``out_last``). ``force``: another run's calls; each call then takes
    that run's experts (``order``) with gates from its own probabilities,
    so two runs compare on the same discrete routing while each records
    its own choice. Dense models make no such call."""

    def __init__(self, force=None):
        self.calls = []
        self._force = force

    def __enter__(self):
        import torch
        from repro_torch.models import moe, transformer
        self._orig = orig = transformer.moe_ffn
        self._route = route = moe.route

        def recorded(params, x, cfg, cdt):
            k, E = cfg.top_k, cfg.n_experts
            T = x.shape[0] * x.shape[1]
            probs, _, experts = route(params["router"], x.reshape(T, -1), k)
            C = moe.capacity(T, k, E, cfg.capacity_factor)
            load = moe.expert_load(experts.reshape(-1), E)
            top = torch.topk(probs, k + 1, dim=-1).values
            call = {"T": T, "k": k,
                    "dropped": (load - C).clamp(min=0).sum(),
                    "order": experts,
                    "experts": torch.sort(experts, dim=-1).values,
                    "margin": top[:, k - 1] - top[:, k]}
            self.calls.append(call)
            out = orig(params, x, cfg, cdt)
            call["out_last"] = out[0].reshape(T, -1)[-1]
            return out

        def forced(router, tokens, top_k):
            probs, _, _ = route(router, tokens, top_k)
            experts = self._force[len(self.calls) - 1]["order"].to(
                probs.device)
            gates = torch.gather(probs, -1, experts)
            return probs, gates / torch.clamp(gates.sum(-1, keepdim=True),
                                              min=1e-9), experts
        transformer.moe_ffn = recorded
        if self._force is not None:
            moe.route = forced
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe, transformer
        transformer.moe_ffn = self._orig
        moe.route = self._route
        return False

    def drop_share(self, calls: int) -> float:
        """Dropped over routed assignments in the first ``calls`` calls."""
        c = self.calls[:calls]
        return float(sum(float(x["dropped"]) for x in c)) \
            / sum(x["T"] * x["k"] for x in c)


def route_flips(want: list, got: list, tie: float, last: bool = False,
                first: bool = False) -> list:
    """The MoE calls (index, and the largest margin among the tokens that
    differ) at which some token's experts differ between two runs'
    ``RouteRecorder.calls``. Every token that differs must be a near-tie
    in ``want``: a margin within ``tie``, else it raises. ``last``: compare
    only each call's last token (a prefill over t + 1 tokens against one
    decode step at t); ``first``: stop at the first call that differs
    (the calls after it see other inputs)."""
    if len(want) != len(got):
        raise AssertionError(f"{len(want)} MoE calls against {len(got)}")
    out = []
    for i, (w, g) in enumerate(zip(want, got)):
        we, ge, m = w["experts"], g["experts"], w["margin"]
        if last:
            we, ge, m = we[-1:], ge[-1:], m[-1:]
        diff = (we.cpu() != ge.cpu()).any(-1)
        if bool(diff.any()):
            worst = float(m.cpu()[diff].max())
            if worst > tie:
                raise AssertionError(
                    f"MoE call {i}: a token took other experts at a router "
                    f"margin of {worst} (> {tie}): not a near-tie")
            out.append((i, worst))
            if first:
                break
    return out


def lm_gates(tag: str, cfg, gen_launches: int, launches: dict, toks,
             requests: int, gen: int, done: list, n_sched: int,
             peak_gb, card_gb) -> None:
    """An LM serving phase's gates: the tensor-core flash kernel launched
    once per layer in generate's prefill and once per layer per admitted
    request in the scheduler's, the SIMT kernel never; generate's tokens
    of shape (requests, gen) inside the vocabulary; every scheduled
    request finished with its ``gen`` tokens; the peak device memory under
    the card's."""
    bad = []
    L = cfg.n_layers
    if gen_launches != L:
        bad.append(f"generate's prefill launched the tensor-core flash "
                   f"kernel {gen_launches} times, not once per layer ({L})")
    tc = launches["flash_attention_tc"]
    if tc - gen_launches != L * n_sched:
        bad.append(f"the scheduler's prefills launched the tensor-core "
                   f"flash kernel {tc - gen_launches} times, not {L} per "
                   f"admitted request")
    if launches["flash_attention"]:
        bad.append(f"the bf16 LM path launched the SIMT flash kernel "
                   f"{launches['flash_attention']} times")
    if tuple(toks.shape) != (requests, gen) \
            or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        bad.append(f"generate returned malformed tokens {toks}")
    if sorted(r.rid for r in done) != list(range(n_sched)) \
            or any(len(r.generated) != gen for r in done):
        bad.append("the scheduler did not finish every request with its "
                   "tokens")
    if not peak_gb < card_gb:
        bad.append(f"peak device memory {peak_gb} GB is not under the "
                   f"card's {card_gb} GB")
    if bad:
        raise AssertionError(f"[{tag}] gates: " + "; ".join(bad))


def phase_lm(dev, card, rec, argv=LM_ARGV, sched_prompts=SCHED_PROMPTS,
             tag: str = "lm") -> tuple:
    """An LM serving path at full width and depth: ``launch.serve --mode
    lm`` with ``argv`` (gemma2-9b: fp32 weights, 4 requests of 8192
    tokens; moonshot: bf16 weights, 4 of 4096; 16 generated), then
    ``DecodeScheduler`` with 2 slots serving ``sched_prompts``. Launch
    counts are zeroed before and read after both; an MoE model's routing
    is recorded (``RouteRecorder``) for the share of generate's prefill
    assignments dropped past capacity. Gates: ``lm_gates``. Returns
    (report, launches, cfg, params)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.serving.scheduler import DecodeScheduler, Request
    cuda = dev.type == "cuda"
    routes = RouteRecorder()
    with rec, routes:
        _build.reset_launches()
        out = serve.main([*argv, "--device", str(dev)])
        gen_launches = _build.LAUNCHES["flash_attention_tc"]
        cfg, params, toks = out["cfg"], out["params"], out["tokens"]
        rep = dict(out["report"])
        rep["generate_peak_gb"] = rep.pop("peak_gb")
        del out
        rng = np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n),
                        max_new=SCHED_GEN)
                for i, n in enumerate(sched_prompts)]
        t0 = time.perf_counter()
        sched = DecodeScheduler(cfg=cfg, params=params, slots=2,
                                max_len=max(sched_prompts) + 2 * SCHED_GEN,
                                device=dev)
        for r in reqs:
            sched.submit(r)
        done = sched.run_to_completion()
        _sync(dev)
        rep["sched_s"] = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    del sched
    rep["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
                      else None)
    card_gb = (torch.cuda.get_device_properties(dev).total_memory / 1e9
               if cuda else float("inf"))
    rep["sched_tokens"] = sum(len(r.generated) for r in done)
    rep["sched_tok_per_s"] = rep["sched_tokens"] / rep["sched_s"]
    rep["flash_launches_per_prefill"] = gen_launches
    rep["param_count"] = cfg.param_count()
    rep["active_param_count"] = cfg.active_param_count()
    rep["drop_share"] = routes.drop_share(cfg.n_layers) if cfg.moe else None
    lm_gates(tag, cfg, gen_launches, launches, toks, rep["requests"],
             rep["gen"], done, len(sched_prompts),
             rep["peak_gb"] if cuda else 0.0, card_gb)
    gb = lambda v: "not measured" if v is None else f"{v:.2f} GB"  # noqa
    moe = (f", {rep['active_param_count']:,} active a token" if cfg.moe
           else "")
    drops = (f"; {rep['drop_share']:.5f} of the prefill's assignments "
             f"dropped past capacity (factor {cfg.capacity_factor})"
             if cfg.moe else "")
    print(f"[{tag}] on {card}: {cfg.name} at full width ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {rep['param_count']:,} params"
          f"{moe}, {cfg.param_dtype} weights, random from seed 0, init "
          f"{rep['init_s']:.2f}s): {rep['requests']} requests x "
          f"{rep['prompt_len']}-token prompts, {rep['gen']} tokens each: "
          f"prefill {rep['prefill_s']:.3f}s, decode "
          f"{rep['decode_ms_per_step']:.2f} ms/step, {rep['tok_per_s']:.2f} "
          f"tok/s{drops}; peak memory {gb(rep['generate_peak_gb'])}; flash "
          f"launches per prefill {gen_launches}", flush=True)
    print(f"[{tag}] DecodeScheduler, 2 slots, requests of {sched_prompts} "
          f"tokens x {SCHED_GEN}: {rep['sched_tokens']} tokens in "
          f"{rep['sched_s']:.2f}s ({rep['sched_tok_per_s']:.2f} tok/s, "
          f"admission prefills included); peak memory {gb(rep['peak_gb'])}; "
          f"launches {launches}", flush=True)
    return rep, launches, cfg, params


def _prompt_len(argv) -> int:
    return int(argv[argv.index("--prompt-len") + 1])


def _rms(x) -> float:
    import torch
    return float(torch.sqrt(torch.mean(x.to(torch.float64) ** 2)))


def _moe_ratio(want: list, got: list) -> float:
    """The median over MoE layers of rms(got - want) / rms(want) of the
    last token's layer outputs in two runs' ``RouteRecorder.calls``."""
    return statistics.median(
        _rms(g["out_last"].float() - w["out_last"].float())
        / _rms(w["out_last"]) for w, g in zip(want, got))


def _rolled_router(params):
    """``params`` with each layer's router columns rolled by one: every
    assignment goes to expert (e + 1) mod E with its own gate."""
    import torch
    ffn = params["layers"]["ffn"]
    return {**params, "layers": {**params["layers"], "ffn": {
        **ffn, "router": torch.roll(ffn["router"], 1, dims=-1)}}}


def phase_lm_checks(dev, cfg, params, rec, prompt_len: int,
                    smoke_archs=LM_SMOKE_ARCHS, profile: bool = False) -> dict:
    """Three checks of an LM path:
    1. the kernels against their plain version on the q, k, v the prefill
       gave a layer of each window (gemma2: one local and one global;
       moonshot: D = 128, global), at one batch row (the plain version
       holds H * S^2 f32 scores): as they came, in bf16 (the tensor-core
       kernel), and cast to f32 (the SIMT kernel), where only the order of
       summation differs (FLASH_TOL);
    2. at full width, the logits of a prefill over t + 1 tokens against a
       prefill over t tokens then one ``decode_step`` (t = 4500), at the
       config's bf16 and at f32 compute. An MoE model runs at a dropless
       capacity factor, E / k (capacity >= T: the served 1.25 drops by
       each batch's own capacity, which differs between t + 1 and t
       tokens). In bf16 the two paths round at other points (other matmul
       shapes and orders of summation) across every layer; in f32 only
       the order of summation differs. The two f32 prefills are the f32
       LM path's counted run (launch counts zeroed before, read after,
       ``rec`` recording): each of their attention calls must take the
       SIMT kernel. Their difference must stay within LM_FULL_CHECK_RMS
       (MoE: MOE_FULL_CHECK_RMS) of the logits' RMS and their argmax agree
       unless the top-2 margin is within twice the largest difference.
       An MoE model is also held on its MoE layers' outputs for the
       position-t token (``RouteRecorder``): the median over layers of
       their relative RMS difference within MOE_FULL_CHECK_RMS. The
       reference's fan-in rule (1/sqrt(E * d) for a 3-D expert leaf)
       makes random experts' outputs small beside attention's, so the
       logits alone barely see the experts. Its routing may differ only
       at near-ties: where the token's experts differ, the first such
       layer's margin in the t + 1 prefill must be within
       MOE_ROUTE_TIE["full"] (``route_flips``; the median takes a few
       such layers). Planted faults, read on the same cache each run,
       must each exceed a limit (in bf16, those of BF16_BLIND excepted):
       decode at ``lengths - 1`` (a wrong position and cache slot); with
       a window, decode with the window off (a wrong mask); with MoE,
       decode with the router's columns rolled by one (each assignment
       sent to expert (e + 1) mod E);
    3. at SMOKE width, ``smoke_archs`` with the same weights on the card
       and on the CPU (llama4 with patches): prefill logits and 3
       teacher-forced decode steps within LM_SMOKE_TOL (the CPU tests'
       tolerances against the JAX package), in f32 and at bf16. An MoE
       model's card run takes the CPU run's experts (``RouteRecorder``'s
       ``force``), as ``tests/test_torch_moe.py`` does against the JAX
       package: where its own choice differs, the CPU margin must be
       within MOE_ROUTE_TIE["smoke"] (a near-tie that bf16 rounding
       flips), and every step is compared.
    ``profile``: where the time of a batch-1 decode step and prefill goes
    (``_device_profile``)."""
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
    for window in dict.fromkeys(TF.layer_windows(cfg)):
        a, kw = rec.args["flash_attention_tc"][(4, prompt_len, window,
                                                cfg.head_dim)]
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
    full = cfg
    if cfg.moe:
        full = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                   / cfg.top_k)
    limits = MOE_FULL_CHECK_RMS if cfg.moe else LM_FULL_CHECK_RMS
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(full, compute_dtype=dtype)
        counted = dtype == "float32"
        rw = RouteRecorder()
        with rec if counted else contextlib.nullcontext():
            _build.reset_launches()
            with rw:
                want = TF.prefill(params, toks, c)[1]
            caches, _ = TF.prefill(params, toks[:, :t], c, pad_to=t + 1)
            launches = dict(_build.LAUNCHES)
        if counted:
            out["f32_launches"] = launches
            if launches["flash_attention"] != 2 * cfg.n_layers \
                    or launches["flash_attention_tc"]:
                raise AssertionError(f"the f32 prefills' attention took "
                                     f"other kernels than the SIMT one "
                                     f"once per layer: {launches}")
        # sound first, then the faults that write slot t (the window off
        # writes it alike; the rolled router from layer 1 on, which only
        # slot t's readers see), then the wrong slot t - 1 last: they all
        # share one cache
        runs = {"sound": (params, lengths, c)}
        if cfg.sliding_window:
            runs["window_off"] = (params, lengths,
                                  dataclasses.replace(c, sliding_window=0))
        if cfg.moe:
            runs["experts_rolled"] = (_rolled_router(params), lengths, c)
        runs["position_minus_1"] = (params, lengths - 1, c)
        logits, routes = {}, {}
        for name, (p, ln, cc) in runs.items():
            with RouteRecorder() as rr:
                logits[name] = TF.decode_step(p, caches, ln, toks[:, t],
                                              cc)[1]
            routes[name] = rr.calls
        got = logits.pop("sound")
        if profile and dtype == cfg.compute_dtype:
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
               "limit": limits["logits"][dtype],
               "planted_rms_ratio": {k: _rms(v - want) / _rms(want)
                                     for k, v in logits.items()}}
        caught = {k: v > chk["limit"]
                  for k, v in chk["planted_rms_ratio"].items()}
        ok = chk["rms_ratio"] <= chk["limit"]
        if cfg.moe:
            chk.update(
                capacity_factor=c.capacity_factor,
                dropped=sum(int(x["dropped"]) for x in rw.calls),
                min_route_margin=min(float(x["margin"][-1])
                                     for x in rw.calls),
                route_flip=route_flips(rw.calls, routes["sound"],
                                       MOE_ROUTE_TIE["full"], last=True,
                                       first=True),
                moe_limit=limits["moe_layers"][dtype],
                moe_rms_ratio=_moe_ratio(rw.calls, routes.pop("sound")),
                planted_moe_rms_ratio={k: _moe_ratio(rw.calls, v)
                                       for k, v in routes.items()})
            ok = ok and chk["moe_rms_ratio"] <= chk["moe_limit"] \
                and chk["dropped"] == 0
            for k, v in chk["planted_moe_rms_ratio"].items():
                caught[k] = caught[k] or v > chk["moe_limit"]
        out[f"full_decode_vs_prefill_{dtype}"] = chk
        if not (ok and bool(torch.isfinite(got).all())):
            raise AssertionError(f"full width, {dtype}: prefill(t+1) vs "
                                 f"prefill(t) + decode_step: {chk}")
        if not chk["argmax_equal"] \
                and chk["top2_margin"] > 2 * chk["max_abs_diff"]:
            raise AssertionError(f"full width, {dtype}: decode's argmax "
                                 f"differs at a clear margin")
        blind = BF16_BLIND.get(cfg.name, ()) if dtype == "bfloat16" else ()
        if not all(v for k, v in caught.items() if k not in blind):
            raise AssertionError(f"full width, {dtype}: a planted fault "
                                 f"stays within the limits: {chk}")
        del got, want, logits
        torch.cuda.empty_cache()

    smoke = {}
    for arch in smoke_archs:
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(get_arch(arch).smoke,
                                    compute_dtype=dtype)
            p_cpu = TF.init_params(c, torch.Generator().manual_seed(0))
            prompts = np.random.default_rng(1).integers(
                1, c.vocab_size, (2, 100))
            prompts[0, 96:] = 0
            patches = None
            if c.fused_patches:
                patches = torch.from_numpy(np.random.default_rng(2).normal(
                    size=(2, c.fused_patches, c.patch_dim)
                ).astype(np.float32))
            res, routes = [], [None]
            for d, p in (("cpu", p_cpu),
                         (dev, lm_params_from_repro(p_cpu, dev))):
                pr = torch.from_numpy(prompts).to(d)
                with RouteRecorder(force=routes[-1]) as rr:
                    caches, lg = TF.prefill(
                        p, pr, c, pad_to=104,
                        patches=None if patches is None else patches.to(d))
                    lengths = (pr > 0).sum(1)
                    steps = [lg.cpu()]
                    for i in range(3):
                        last = torch.from_numpy(prompts[:, i + 1]).to(d)
                        caches, lg = TF.decode_step(p, caches, lengths + i,
                                                    last, c)
                        steps.append(lg.cpu())
                res.append(torch.stack(steps))
                routes.append(rr.calls)
            err = float((res[0] - res[1]).abs().max())
            smoke[f"{arch}/{dtype}"] = err
            if c.moe:
                flips = route_flips(routes[1], routes[2],
                                    MOE_ROUTE_TIE["smoke"])
                if flips:
                    smoke[f"{arch}/{dtype}/route_flips"] = flips
            if not err <= LM_SMOKE_TOL[dtype]:
                raise AssertionError(f"smoke {arch} {dtype}: card logits "
                                     f"differ from the CPU's by {err}")
    out["smoke_card_vs_cpu_max_abs"] = smoke
    return out


# --------------------------------------------------------------------------
# the LM training path ([train], [train-checks])
# --------------------------------------------------------------------------

# stablelm-12b (launch/train.py's default arch) at its published widths,
# 8 of its 40 layers: fp32 params, grads and AdamW's m and v take 16 B a
# parameter, 194.3 GB at 40 layers and 52.0 GB at 8 (3.25 B params); the
# widths, 4096-token sequences and the vocabulary are not cut
TRAIN_ARCH = "stablelm-12b"
TRAIN_LAYERS = 8
# lr 1e-5, not the driver's default 3e-4: Adam's first steps move every
# weight by about lr (the gradient's sign), and at d_model 5120 that moves
# a layer's outputs by O(1) of their scale; with no warm-up (the JAX
# driver has none) the loss then rises (tools/train_lr_scan.py)
TRAIN_ARGV = ["--steps", "6", "--batch", "2", "--seq", "4096", "--lr",
              "1e-5", "--log-every", "1"]
# the gradient check: 2 layers, one 4096-token sequence
TRAIN_GRAD_LAYERS = 2
TRAIN_GRAD_SEQ = 4096
# the largest relative RMS (per leaf) of the bf16-compute gradient against
# the f32-compute one: 1.3x the largest bf16 spread of the CPU tests
# (0.0221 port against JAX, tests/test_torch_train.py; 0.0230 bf16 against
# f32 at SMOKE width); on the CPU a 1280-wide 2-layer stablelm over 4096
# tokens read 0.0114 sound, 0.4922 with the causal mask off and 0.0765
# with q rotated one position ahead of k
TRAIN_GRAD_LIMIT = 0.03
TRAIN_SMOKE_ARCHS = ("stablelm-12b", "gemma2-9b", "moonshot-v1-16b-a3b")
TRAIN_SMOKE_STEPS = 2
# card against the CPU at SMOKE width: loss and grad norm (relative), and
# each leaf's update over the steps (tests/test_torch_train.py's rule: at
# f32 within STEP_RMS of its RMS; at bf16 at most STEP_FLIPS of its
# elements off by more than STEP_ABS, a gradient within rounding of 0
# moving a param by up to 2 lr a step, none by more)
TRAIN_SMOKE_TOL = {"float32": 2e-5, "bfloat16": 1e-3}
STEP_RMS, STEP_ABS, STEP_FLIPS = 1e-3, 1e-5, 0.02
# the card's bf16 sums differ from the CPU's more than the two packages'
# on the CPU: over 2 steps the largest share of a leaf's elements off was
# 2.66% (stablelm), 3.13% (gemma2) and 0.84% (moonshot) on an H100; a
# wrong gradient moves most of them
TRAIN_SMOKE_FLIPS = 0.10
MICRO_RTOL = 2e-3                   # tests/test_training.py's
# a resumed run's losses against the uninterrupted one's on the card (the
# embedding's and the dispatch's backward add by atomics there, so not bit
# for bit); its params by update_gate at f32
RESUME_LOSS_TOL = 1e-5


def train_gates(tag: str, losses: list, grad_norms: list) -> None:
    """A training run's gates: every loss and grad norm finite, and the
    loss at the last step below the first step's."""
    import math
    bad = []
    if not losses or not all(math.isfinite(x) for x in losses + grad_norms):
        bad.append(f"a loss or grad norm is not finite: {losses} "
                   f"{grad_norms}")
    elif not losses[-1] < losses[0]:
        bad.append(f"the loss did not fall: {losses[0]} at the first step, "
                   f"{losses[-1]} at the last")
    if bad:
        raise AssertionError(f"[{tag}] gates: " + "; ".join(bad))


def update_readings(got: list, want: list, before: list) -> dict:
    """Each leaf's update (after minus before) against the reference's:
    the largest relative RMS of their difference, the largest share of
    elements off by more than STEP_ABS, and the largest difference."""
    import torch
    rms = flips = worst = 0.0
    for a, b, c in zip(got, want, before, strict=True):
        da = a.double().cpu() - c.double().cpu()
        db = b.double().cpu() - c.double().cpu()
        off = (da - db).abs()
        rms = max(rms, float(torch.sqrt((off ** 2).mean())
                             / torch.sqrt((db ** 2).mean()).clamp(
                                 min=1e-30)))
        flips = max(flips, float((off > STEP_ABS).double().mean()))
        worst = max(worst, float(off.max()))
    return {"update_rms_ratio": rms, "share_off": flips, "max_abs": worst}


def update_gate(readings: dict, dtype: str, steps: int, lr: float,
                flips: float = STEP_FLIPS) -> None:
    """``update_readings``' limits: at f32 within STEP_RMS of the update's
    RMS; at bf16 at most ``flips`` of a leaf's elements off by more than
    STEP_ABS; none off by more than 2 lr a step."""
    ok = readings["max_abs"] <= 2 * lr * steps * (1 + 1e-3) and (
        readings["update_rms_ratio"] <= STEP_RMS if dtype == "float32"
        else readings["share_off"] <= flips)
    if not ok:
        raise AssertionError(f"the params' update differs ({dtype}): "
                             f"{readings}")


@contextlib.contextmanager
def flipped_gradient():
    """A planted fault: AdamW takes every gradient with its sign flipped
    (an ascent)."""
    from repro_torch import tree
    from repro_torch.optim import adamw
    orig = adamw.update

    def flipped(params, grads, state, **kw):
        for g in tree.leaves(grads):
            g.neg_()
        return orig(params, grads, state, **kw)
    adamw.update = flipped
    try:
        yield
    finally:
        adamw.update = orig


@contextlib.contextmanager
def causal_mask_dropped():
    """A planted fault: the train attention attends to later positions."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    orig = TF._train_attention

    def open_attention(q, k, v, window, cfg):
        return L.blockwise_attention(q, k, v, causal=False, window=window,
                                     softcap=cfg.attn_softcap,
                                     block_q=cfg.attn_block_q,
                                     block_kv=cfg.attn_block_kv)
    TF._train_attention = open_attention
    try:
        yield
    finally:
        TF._train_attention = orig


@contextlib.contextmanager
def rope_shifted(n_heads: int):
    """A planted fault: queries rotated one position ahead of the keys
    (rope is relative: shifting both would change nothing)."""
    from repro_torch.models import layers as L
    orig = L.apply_rope

    def shifted(x, positions, inv_freq, rot_dim):
        if x.shape[-2] == n_heads:
            positions = positions + 1
        return orig(x, positions, inv_freq, rot_dim)
    L.apply_rope = shifted
    try:
        yield
    finally:
        L.apply_rope = orig


def _train_grads(params, batch, cfg) -> list:
    """forward_train's gradient of every leaf (the step's own
    ``_grads``)."""
    from repro_torch.models import transformer as TF
    from repro_torch.training.train_step import _grads
    return _grads(lambda p, b: TF.forward_train(p, b, cfg), params,
                  batch)[2]


def _leaf_rms_ratio(got: list, want: list) -> float:
    return max(_rms(g.float() - w.float()) / max(_rms(w), 1e-30)
               for g, w in zip(got, want, strict=True))


def train_grad_check(dev, cfg, seq: int) -> dict:
    """The bf16-compute gradient of ``cfg`` (full width, cut to a few
    layers) against the f32-compute gradient of the same weights and one
    ``seq``-token batch: the largest relative RMS over leaves within
    TRAIN_GRAD_LIMIT, and above it with the causal mask dropped and with
    the queries' rope one position ahead."""
    import dataclasses
    import torch
    from repro_torch.data.lm import LMBatches
    from repro_torch.models import transformer as TF
    params = TF.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in LMBatches(
        cfg.vocab_size, 1, seq, seed=0).batch_at(0).items()}
    want = _train_grads(params, batch,
                        dataclasses.replace(cfg, compute_dtype="float32"))
    out = {"layers": cfg.n_layers, "seq": seq, "limit": TRAIN_GRAD_LIMIT}
    runs = {"sound": contextlib.nullcontext(),
            "causal_mask_dropped": causal_mask_dropped(),
            "rope_q_plus_1": rope_shifted(cfg.n_heads)}
    for name, fault in runs.items():
        with fault:
            got = _train_grads(params, batch, cfg)
        out[name] = _leaf_rms_ratio(got, want)
        del got
    del params, want
    if not (out["sound"] <= TRAIN_GRAD_LIMIT
            < min(out["causal_mask_dropped"], out["rope_q_plus_1"])):
        raise AssertionError(f"[train] gradient check: {out}")
    return out


def phase_train(dev, card, cfg, argv=TRAIN_ARGV,
                grad_layers: int = TRAIN_GRAD_LAYERS,
                grad_seq: int = TRAIN_GRAD_SEQ) -> dict:
    """LM training through ``launch.train``'s loop (``run``) on ``cfg``
    (stablelm-12b's published widths, TRAIN_LAYERS of its 40 layers):
    fp32 params and AdamW state, bf16 compute, ``argv``'s steps on
    ``LMBatches`` (seed 0). Each step's loss and grad norm, the median
    step of all but the first, tok/s, the peak device memory and the
    model-FLOP share (6 x params x tokens + 12 x layers x B x S^2 x H x D,
    a step's, over the step's seconds, at the bf16 dense peak). Gates:
    ``train_gates``; the same steps with the gradient's sign flipped
    must fail them; ``train_grad_check`` at ``grad_layers`` layers."""
    import dataclasses
    import torch
    from repro_torch.launch import train as T
    from repro_torch.training import train_step as TS
    cuda = dev.type == "cuda"
    args = T.build_parser().parse_args([*argv, "--device", str(dev)])
    runs = {}
    for name, fault in (("sound", contextlib.nullcontext()),
                        ("gradient_sign_flipped", flipped_gradient())):
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        with fault:
            out = T.run(cfg, TS.make_lm_train_step(cfg, lr=args.lr), args,
                        dev)
        runs[name] = {k: out[k] for k in ("losses", "grad_norms",
                                          "step_s", "init_s")}
        runs[name]["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                                 if cuda else None)
        del out
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    rep = dict(runs["sound"])
    train_gates("train", rep["losses"], rep["grad_norms"])
    flipped = runs["gradient_sign_flipped"]
    try:
        train_gates("train", flipped["losses"], flipped["grad_norms"])
    except AssertionError:
        rep["flipped_caught"] = True
    else:
        raise AssertionError(f"[train] the gradient's sign flipped passes "
                             f"the gates: {flipped}")
    rep["flipped_losses"] = flipped["losses"]
    B, S = args.batch, args.seq
    rep["param_count"] = cfg.param_count()
    rep["tokens_per_step"] = B * S
    rep["median_step_s"] = statistics.median(rep["step_s"][1:])
    rep["tok_per_s"] = B * S / rep["median_step_s"]
    flops = 6 * rep["param_count"] * B * S + 12 * cfg.n_layers * B * S \
        * S * cfg.n_heads * cfg.head_dim
    rep["model_flops_per_step"] = flops
    rep["model_flop_share"] = flops / rep["median_step_s"] / BF16_OPS_PER_S
    gb = lambda v: "not measured" if v is None else f"{v:.2f} GB"  # noqa
    print(f"[train] on {card}: {cfg.name} at its published widths, "
          f"{cfg.n_layers} of its layers (d_model {cfg.d_model}, "
          f"{rep['param_count']:,} params, fp32 params and AdamW state, "
          f"{cfg.compute_dtype} compute, init {rep['init_s']:.2f}s): "
          f"{args.steps} steps of {B} x {S} tokens, lr {args.lr}", flush=True)
    for i, (l, g, s) in enumerate(zip(rep["losses"], rep["grad_norms"],
                                      rep["step_s"])):
        print(f"[train] step {i}: loss {l:.4f}, grad norm {g:.4f}, "
              f"{s:.3f}s", flush=True)
    print(f"[train] on {card}: median step {rep['median_step_s']:.3f}s "
          f"(steps 2-{args.steps}), {rep['tok_per_s']:.1f} tok/s, peak "
          f"memory {gb(rep['peak_gb'])}, model-FLOP share "
          f"{rep['model_flop_share']:.4f} of {BF16_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s; the gradient's sign flipped: losses "
          f"{[round(x, 4) for x in flipped['losses']]} (caught)", flush=True)
    gcfg = dataclasses.replace(cfg, n_layers=grad_layers)
    rep["grad_check"] = train_grad_check(dev, gcfg, grad_seq)
    print(f"[train] gradient check ({grad_layers} layers, 1 x {grad_seq} "
          f"tokens): bf16 against f32 compute, largest relative RMS over "
          f"leaves {rep['grad_check']['sound']:.5f} (limit "
          f"{TRAIN_GRAD_LIMIT}); causal mask dropped "
          f"{rep['grad_check']['causal_mask_dropped']:.5f}, q rotated one "
          f"position ahead {rep['grad_check']['rope_q_plus_1']:.5f}",
          flush=True)
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return rep


def _smoke_train(cfg, params, batches: list, dev, n_micro: int = 1,
                 force=None) -> dict:
    """``len(batches)`` steps of ``make_lm_train_step`` from a copy of
    ``params`` on ``dev``; an MoE model's routing recorded (or, with
    ``force``, taken from another run's calls). Returns the losses, grad
    norms, final params (on the CPU) and the routing calls."""
    import torch
    from repro_torch import tree
    from repro_torch.convert import lm_params_from_repro
    from repro_torch.optim import adamw
    from repro_torch.training import train_step as TS
    p = lm_params_from_repro(params, dev)
    opt = adamw.init(p)
    step = TS.make_lm_train_step(cfg, n_microbatch=n_micro)
    losses, norms = [], []
    with RouteRecorder(force=force) as rr:
        for i, b in enumerate(batches):
            p, opt, m = step(p, opt, {k: torch.from_numpy(v).to(dev)
                                      for k, v in b.items()}, i)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms,
            "params": [t.cpu() for t in tree.leaves(p)], "routes": rr.calls}


def _rel(a: list, b: list) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b,
                                                               strict=True))


def torn_save_caught(dev, tmp, fault: bool) -> bool:
    """Save params and AdamW state with ``AsyncCheckpointer``, update
    them in place right after ``save_async`` returns (the writer held
    until then), and restore: whether the restored state differs from the
    state at the save. ``fault``: ``save_async`` without its host copy."""
    import threading
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint import ckpt
    from repro_torch.optim import adamw
    params = {"w": torch.randn((256, 256), device=dev)}
    opt = adamw.init(params)
    state = {"params": params, "opt": opt}
    want = tree.tree_map(lambda t: t.detach().cpu().clone(), state)
    go = threading.Event()
    orig_save, orig_copy = ckpt.save, ckpt.host_copy

    def held(*a, **kw):
        go.wait(60)
        return orig_save(*a, **kw)
    ckpt.save = held
    if fault:
        ckpt.host_copy = lambda t: t
    try:
        acp = ckpt.AsyncCheckpointer(tmp)
        acp.save_async(0, state)
        adamw.update(params, {"w": torch.ones_like(params["w"])}, opt,
                     lr=1e-2)
        go.set()
        acp.wait()
    finally:
        ckpt.save, ckpt.host_copy = orig_save, orig_copy
        go.set()
    got, _ = ckpt.restore(tmp, want)
    return not all(torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                                     tree.leaves(want)))


def phase_train_checks(dev, tmp) -> dict:
    """The training path at SMOKE width on the card against the port's
    own CPU path on the same weights and batches:
    1. TRAIN_SMOKE_ARCHS (stablelm; gemma2 with softcaps, local windows
       and sandwich norms over 128 tokens, past its 64-token window;
       moonshot's MoE backward and aux loss) at f32 and at bf16 compute,
       TRAIN_SMOKE_STEPS AdamW steps: losses and grad norms within
       TRAIN_SMOKE_TOL, the params' update by ``update_gate`` (an MoE
       model's card run takes the CPU run's experts; where its own choice
       differs the CPU margin must be a near-tie, MOE_ROUTE_TIE["smoke"]);
    2. ``n_microbatch=4`` against 1 on the card (stablelm, bf16): loss
       within MICRO_RTOL, params within the JAX test's rtol 2e-2 / atol
       1e-3;
    3. ``launch.train``'s loop (stablelm SMOKE at f32 compute)
       checkpointed at step 2 by ``AsyncCheckpointer``, killed, resumed
       (``--resume auto``) to step 4, against the uninterrupted run:
       losses within RESUME_LOSS_TOL, the params' update within its RMS ratio
       and 2 lr a step (bit for bit is asked of the CPU only:
       tests/test_torch_train.py);
    4. a save that an in-place update follows at once restores the state
       at the save; with the host copy removed (a planted torn save) the
       check sees the difference.
    Layers run without remat here (it changes no value, and the recorded
    routing then has one call per layer and forward)."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.lm import LMBatches
    from repro_torch.launch import train as T
    from repro_torch.models import transformer as TF
    from repro_torch.training import train_step as TS
    cpu = torch.device("cpu")
    out, gates = {}, []
    lr = 3e-4
    for arch in TRAIN_SMOKE_ARCHS:
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(get_arch(arch).smoke,
                                    compute_dtype=dtype, remat=False)
            params = TF.init_params(c, torch.Generator().manual_seed(0))
            data = LMBatches(c.vocab_size, 2, 128, seed=1)
            batches = [data.batch_at(i) for i in range(TRAIN_SMOKE_STEPS)]
            want = _smoke_train(c, params, batches, cpu)
            got = _smoke_train(c, params, batches, dev,
                               force=want["routes"] if c.moe else None)
            chk = {"loss": _rel(got["losses"], want["losses"]),
                   "grad_norm": _rel(got["grad_norms"], want["grad_norms"]),
                   **update_readings(got["params"], want["params"],
                                     tree.leaves(params))}
            if c.moe:
                chk["route_flips"] = route_flips(want["routes"],
                                                 got["routes"],
                                                 MOE_ROUTE_TIE["smoke"])
            out[f"{arch}/{dtype}"] = chk
            gates.append((f"{arch} {dtype}", chk, dtype))

    c = get_arch("stablelm-12b").smoke
    params = TF.init_params(c, torch.Generator().manual_seed(0))
    b = LMBatches(c.vocab_size, 8, 32, seed=2).batch_at(0)
    one, four = (_smoke_train(c, params, [b], dev, n_micro=n)
                 for n in (1, 4))
    micro = {"loss": _rel(four["losses"], one["losses"]),
             "params_close": all(
                 torch.allclose(x, y, rtol=2e-2, atol=1e-3)
                 for x, y in zip(four["params"], one["params"]))}
    out["microbatch_4_vs_1"] = micro

    base = ["--steps", "5", "--batch", "2", "--seq", "64", "--log-every",
            "1", "--device", str(dev)]
    ck = ["--ckpt-dir", str(tmp / "resume"), "--ckpt-every", "2",
          "--resume", "auto"]
    parse = T.build_parser().parse_args
    cfg, _ = T.build("stablelm-12b", smoke=True, device=dev)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    step_fn = TS.make_lm_train_step(cfg, lr=lr)
    whole = T.run(cfg, step_fn, parse(base), dev)
    T.run(cfg, step_fn, parse([*base, "--steps", "3", *ck]), dev)
    resumed = T.run(cfg, step_fn, parse([*base, *ck]), dev)
    init = tree.leaves(T.init_state(cfg, 0, dev)[0])
    res = {"start": resumed["start"],
           "loss": _rel(resumed["losses"], whole["losses"][3:]),
           "bitwise": all(torch.equal(a, b) for a, b in zip(
               tree.leaves(resumed["params"]),
               tree.leaves(whole["params"]))),
           **update_readings(tree.leaves(resumed["params"]),
                             tree.leaves(whole["params"]), init)}
    out["resume_at_3_vs_whole"] = res
    torn = {"sound": torn_save_caught(dev, tmp / "sound", fault=False),
            "host_copy_removed": torn_save_caught(dev, tmp / "torn",
                                                  fault=True)}
    out["torn_save"] = torn

    bad = []
    for what, chk, dtype in gates:
        if not max(chk["loss"], chk["grad_norm"]) <= TRAIN_SMOKE_TOL[dtype]:
            bad.append(f"{what}: the card's losses or grad norms differ "
                       f"from the CPU's")
        try:
            update_gate(chk, dtype, TRAIN_SMOKE_STEPS, lr,
                        flips=TRAIN_SMOKE_FLIPS)
        except AssertionError as e:
            bad.append(f"{what}: {e}")
    if not (micro["loss"] <= MICRO_RTOL and micro["params_close"]):
        bad.append("4 microbatches differ from the full batch")
    try:
        update_gate(res, "float32", 5, lr)
    except AssertionError as e:
        bad.append(f"the resumed run: {e}")
    if res["start"] != 3 or not res["loss"] <= RESUME_LOSS_TOL:
        bad.append("the resumed run differs from the uninterrupted one")
    if torn != {"sound": False, "host_copy_removed": True}:
        bad.append("the torn-save check")
    if bad:
        raise AssertionError("[train-checks] " + "; ".join(bad)
                             + f": {out}")
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
    attention (batch, q length, window, head dim)."""
    if name.startswith("flash_attention"):
        return (int(args[0].shape[0]), int(args[0].shape[1]),
                int(kwargs.get("window", 0)), int(args[0].shape[3]))
    return int(args[1 if name == "bm25_blocks_compact" else 0].shape[0])


class ShapeRecorder:
    """Wraps the kernel ops the main paths call, only while a path runs
    (``with rec:``, once per counted run): counts each op's calls by their
    shape key S (blocks; for flash attention batch, length, window and
    head dim) and keeps a copy of the first call's arguments at each S, so
    ``phase_timing`` can time every kernel on the inputs the paths gave
    it. Flash attention's calls go under the kernel ``ops.route`` picks
    for them. The launch counts stay the wrappers' own. Calls come from
    several threads at once (ingest, merges, the refresh daemon, serving),
    so ``counts`` and ``args`` change under a lock."""

    def __init__(self):
        import collections
        import threading
        self._lock = threading.Lock()
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
            with self._lock:
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
    """The durable path (phase 11 of the module docstring). Returns its
    report, the launch counts of its two counted runs, summed, and its
    corpus batches (the later phases index the same corpus)."""
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
        env_rep = ix.envelope_report()
        rep["envelope"] = env_rep
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
        print(f"[durable] envelope_report on {card}: "
              f"{env_rep['bytes_read_measured']} bytes indexed, "
              f"{env_rep['bytes_written_measured']} written to the local "
              f"disk ({env_rep['index_bytes_encoded']} live encoded) in "
              f"{env_rep['t_io_measured_s']:.2f}s of measured write + read "
              f"wall time: {env_rep['gb_per_min_measured']:.3f} GB/min "
              f"measured; modeled {env_rep['gb_per_min_modeled']:.3f} "
              f"GB/min for ceph->ssd in the paper's media units (bound "
              f"{env_rep['bound']}); alpha_measured "
              f"{env_rep['alpha_measured']:.4f}, {env_rep['n_merges']} "
              f"merges; WAL appends {env_rep['wal_appends']}", flush=True)

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
    return rep, launches, batches


ENVELOPE_PAIRS = (("nas", "ssd"), ("ssd", "ssd"))   # isolated, shared
ENVELOPE_BATCHES = 1                # of --batch-docs: 2^14 docs a pair
STEADY_SEED_BATCHES = 4             # indexed and refreshed before serving
# churn ticks, one batch each. Not cut: the one merge the gates need takes
# the 10 flushes of all 40 batches (a flush every 4 batches at CONFIG's
# 256 MB budget), and ticks moved to the seed saved no time
STEADY_TICKS = 36
STEADY_DELETE_EVERY = 4             # every 4th tick deletes ...
STEADY_DELETES = 8                  # ... this many served docs
STEADY_MIN_REFRESHES = 10           # daemon refreshes, and generations
# the open-loop arrival rate, fixed: the JAX package's serve_steady bench
# offers 75 QPS (benchmarks/run.py:1087). Paced from [slice]'s QPS, the
# load followed the slice's depth, not what [steady] serves.
STEADY_QPS = 75.0
# 4-term queries the arrivals draw, drawn as [slice] draws its queries:
# a hot set that repeats, so the result cache answers most arrivals.
# [slice]'s 1024 distinct queries at its half rate would send most
# arrivals to the scorers of an index five times [slice]'s size, where
# closed-loop serving reaches well under that rate (about 200 QPS at 2^18
# docs, 33 at 2^20). The misses' own tail is reported beside the whole.
STEADY_POOL = 64
STEADY_SECONDS = 90.0               # of arrivals
# s between ticks, never 0: a churn loop that spins once its ticks are in
# starves the serving thread of the GIL, and serving all but stops
STEADY_TICK_GAP = 0.25
STEADY_SURFACE_S = 60.0             # the longest a change may take to surface
EXAMPLES = ("torch_quickstart.py", "torch_index_corpus.py",
            "torch_serve_retrieval.py", "torch_serve_fleet.py",
            "torch_train_lm.py")
EXAMPLE_ARGS = {"torch_train_lm.py": ("--steps", "40")}
FLEET_SHARDS = 2                    # range shards, each with ...
FLEET_REPLICAS = 2                  # ... this many replicas
FLEET_BATCHES = 1                   # of FLEET_BATCH_DOCS a shard ...
FLEET_DELETES = 8                   # ... then one more batch and 8 deletes
FLEET_BATCH_DOCS = 1 << 13          # docs a fleet batch (at most --batch-docs)
FLEET_RANGE = 1 << 24               # shard si owns ids [si, si + 1) * this
FLEET_SERVE_BATCHES = 8             # closed-loop batches of 32 queries
FLEET_DEGRADED_BATCHES = 8          # served while a replica is quarantined
FLEET_HEALED_BATCHES = 2            # served after each heal
FLEET_TIMEOUT_S = 600.0             # the longest a replica process may take


def _live_file_bytes(path) -> int:
    """Bytes on the target of the newest commit's segments, from the
    file system: each segment's four files and its current ``.liv``."""
    from repro_torch.storage import (SEGMENT_SUFFIXES, FSDirectory,
                                     list_commits, read_commit)
    d = FSDirectory(str(path))
    meta = read_commit(d, f"segments_{list_commits(d)[0]}")
    total = 0
    for base in meta["segments"]:
        names = [base + sfx for sfx in SEGMENT_SUFFIXES]
        if meta["liv"].get(base):
            names.append(meta["liv"][base])
        total += sum(os.path.getsize(Path(path) / n) for n in names)
    return total


def envelope_gates(reps: dict, spooled: dict, file_bytes: dict) -> float:
    """The [envelope] gates on each pair's ``envelope_report()``: the
    source bytes it measured are the spooled bytes, the encoded bytes of
    the live segments are their files' bytes on the target, and the
    isolated pair beats the shared one (the paper's headline, in throttle
    device time). Returns the isolation speedup."""
    bad = []
    for pair, rep in reps.items():
        if rep["bytes_read_measured"] != spooled[pair]:
            bad.append(f"{pair}: bytes_read_measured "
                       f"{rep['bytes_read_measured']} != spooled "
                       f"{spooled[pair]}")
        if rep["index_bytes_encoded"] != file_bytes[pair]:
            bad.append(f"{pair}: index_bytes_encoded "
                       f"{rep['index_bytes_encoded']} != live segment files "
                       f"{file_bytes[pair]}")
    iso, shared = (reps[p]["gb_per_min_measured"] for p in ENVELOPE_PAIRS)
    speedup = iso / shared if shared > 0 else float("inf")
    if not speedup > 1.0:
        bad.append(f"isolation speedup {speedup} is not above 1")
    if bad:
        raise AssertionError("[envelope] gates: " + "; ".join(bad))
    return speedup


def phase_envelope(args, dev, card, rec, made=(), k: int = 10) -> tuple:
    """The paper's experiment on the card (``benchmarks/run.py``'s
    ``envelope_measured`` at CONFIG width): per pair, spool
    ENVELOPE_BATCHES batches into a throttled RAM source, index them with
    ``index_spooled`` into a throttled ``FSDirectory`` target under
    ``build/``, ``finalize()``, report; recover the commit on the card
    and serve 32 queries, pruned against exhaustive. ``made``: batches of
    this corpus made already (the durable path's), spooled as they are.
    Returns (report, launches of the counted runs, summed)."""
    import dataclasses
    import shutil
    import types
    import numpy as np
    import torch
    from repro_torch.configs.lucene_envelope import CONFIG
    from repro_torch.core import envelope as env
    from repro_torch.core.indexer import Indexer
    from repro_torch.core.searcher import IndexSearcher, ReaderCache
    from repro_torch.data.corpus import (CW09B_SMALL, SyntheticCorpus,
                                         spool_corpus)
    from repro_torch.kernels import _build
    from repro_torch.storage import (MEDIA_PROFILES, DeviceThrottle,
                                     FSDirectory, RAMDirectory,
                                     ThrottledDirectory, open_latest)
    n_docs = ENVELOPE_BATCHES * args.batch_docs
    corpus = SyntheticCorpus(dataclasses.replace(CW09B_SMALL, n_docs=n_docs),
                             doc_buffer_len=CONFIG.doc_len)
    if len(made) >= ENVELOPE_BATCHES:
        corpus = types.SimpleNamespace(batch=lambda i, n: made[i])
    rng = np.random.default_rng(0)
    vocab = np.unique(corpus.batch(0, 32))[1:]
    q = np.stack([rng.choice(vocab, 4, replace=False)
                  for _ in range(32)]).astype(np.int32)
    root = ROOT / "build" / f"chip_smoke_envelope_{os.getpid()}"
    shutil.rmtree(root, ignore_errors=True)
    out = {"docs": n_docs, "pairs": {}}
    reps, spooled, files = {}, {}, {}
    launches = {n: 0 for n in _build.LAUNCHES}
    try:
        for sp, tp in ENVELOPE_PAIRS:
            # one device (one throttle) when the profiles match
            th_t = DeviceThrottle(MEDIA_PROFILES[tp])
            th_s = th_t if sp == tp else DeviceThrottle(MEDIA_PROFILES[sp])
            src = ThrottledDirectory(RAMDirectory(), th_s)
            path = root / f"{sp}__{tp}"
            t0 = time.perf_counter()
            spooled[(sp, tp)] = spool_corpus(corpus, src, ENVELOPE_BATCHES,
                                             args.batch_docs)
            spool_s = time.perf_counter() - t0
            src.reset_counters()
            th_s.reset()   # spooling predates the run
            with rec:
                _build.reset_launches()
                t0 = time.perf_counter()
                ix = Indexer(cfg=CONFIG, device=dev,
                             source=env.PROFILE_TO_MEDIA[sp],
                             target=env.PROFILE_TO_MEDIA[tp],
                             source_dir=src, target_dir=ThrottledDirectory(
                                 FSDirectory(str(path)), th_t))
                indexed = ix.index_spooled()
                ix.finalize()
                _sync(dev)
                wall = time.perf_counter() - t0
                rep = ix.envelope_report()
                ix.close()
                t0 = time.perf_counter()
                gen, segs = open_latest(FSDirectory(str(path)), device=dev)
                pruned = ReaderCache(device=dev).refresh(segs)
                v_p, i_p = pruned.search_batched(q, k)
                _sync(dev)
                recover_s = time.perf_counter() - t0
                counted = dict(_build.LAUNCHES)
            for n, c in counted.items():
                launches[n] += c
            dense = IndexSearcher(readers=pruned.readers, prune=False,
                                  device=dev)
            v_d, i_d = dense.search_batched(q, k)
            if not torch.equal(v_p.view(torch.int32), v_d.view(torch.int32)):
                raise AssertionError(f"[envelope] {sp}->{tp}: pruned != "
                                     f"exhaustive on the recovered commit")
            check_ids_by_true_score(dense, q, v_p, i_p, i_d)
            if not (pruned.n_docs == indexed == n_docs) \
                    or not bool(torch.isfinite(v_p).all()):
                raise AssertionError(f"[envelope] {sp}->{tp}: recovered "
                                     f"{pruned.n_docs} docs of {indexed} "
                                     f"indexed, {n_docs} spooled")
            _require(counted, ("pack", "unpack"), f"[envelope] {sp}->{tp}")
            if not (counted["bm25_blocks"] + counted["bm25_blocks_midgrid"]):
                raise AssertionError(f"[envelope] {sp}->{tp}: serving "
                                     f"launched no BM25 kernel: {counted}")
            files[(sp, tp)] = _live_file_bytes(path)
            reps[(sp, tp)] = rep
            out["pairs"][f"{sp}->{tp}"] = dict(
                rep, wall_s=wall, spool_s=spool_s, recover_s=recover_s,
                spooled_bytes=spooled[(sp, tp)],
                live_file_bytes=files[(sp, tp)], launches=counted,
                commit_gen=gen)
            del ix, pruned, dense, segs
            shutil.rmtree(path, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    speedup = envelope_gates(reps, spooled, files)
    out["isolation_speedup"] = speedup
    for (sp, tp), rep in reps.items():
        o = out["pairs"][f"{sp}->{tp}"]
        print(f"[envelope] on {card}: {sp}->{tp} (modeled as "
              f"{env.PROFILE_TO_MEDIA[sp]}->{env.PROFILE_TO_MEDIA[tp]}), "
              f"{n_docs} docs, {rep['bytes_read_measured']} source bytes: "
              f"measured {rep['gb_per_min_measured']:.4f} GB/min of "
              f"throttle device time (t_io {rep['t_io_measured_s']:.4f}s, "
              f"shared {rep['shared_media_measured']}); modeled "
              f"{rep['gb_per_min_modeled']:.4f} GB/min in the paper's media "
              f"units, bound {rep['bound']}; alpha_measured "
              f"{rep['alpha_measured']:.4f} ({rep['n_merges']} merges); "
              f"index {rep['index_bytes_encoded']} encoded bytes; wall "
              f"{o['wall_s']:.2f}s to durable (spool {o['spool_s']:.2f}s "
              f"apart), recovery + 32 queries {o['recover_s']:.2f}s; "
              f"launches {o['launches']}", flush=True)
    mruns = [env.measured_run_from_report(s, t, r, "t_io_measured_s")
             for (s, t), r in reps.items()]
    media, p, _ = env.calibrate(measured=mruns, measured_weight=0.1)
    out["calibrated"] = {"params": dataclasses.asdict(p), "media": {
        n: dataclasses.asdict(m) for n, m in media.items()}}
    print(f"[envelope] isolation speedup (nas->ssd over ssd->ssd measured "
          f"GB/min) {speedup:.4f}; calibrate() refitted with the {len(mruns)}"
          f" measured runs (weight 0.1): alpha {p.alpha:.4f}, c_idx "
          f"{p.c_idx:.2f}, interference {p.interference:.4f}, zfs write "
          f"{media['zfs'].write_bw:.4f} GB/s, xfs write "
          f"{media['xfs'].write_bw:.4f} GB/s (model units)", flush=True)
    return out, launches


def probe_qps(searcher, pool, slots: int, max_terms: int, k: int) -> dict:
    """Closed loop, no cache: ``warm_searcher``'s probe batches (every
    pow2 batch bucket up to ``slots`` at every pow2 occupancy) run once
    more over ``searcher``; its queries over the wall time. Results come
    back on the host, so the clock brackets the device's work. A probe
    that served no query measured nothing, and fails."""
    import numpy as np
    from repro_torch.serving.steady import warm_searcher

    class _Counting:
        def __init__(self):
            self.queries = 0

        def search_batched(self, q, kk):
            self.queries += int((np.asarray(q) >= 0).any(axis=1).sum())
            return searcher.search_batched(q, kk)

    counting = _Counting()
    t0 = time.perf_counter()
    warm_searcher(counting, pool, slots, max_terms, k)
    secs = time.perf_counter() - t0
    if not (counting.queries > 0 and secs > 0):
        raise AssertionError(f"the probe measured no QPS: "
                             f"{counting.queries} queries in {secs} s")
    return {"queries": counting.queries, "s": secs,
            "qps": counting.queries / secs}


def miss_latency_ms(requests) -> dict:
    """p50/p99/p999 ms (intended arrival -> result) of the completed
    requests the result cache did not answer: the arrivals the scorers
    served. Zeros when there were none."""
    import numpy as np
    lat = np.array([(r.t_done - r.t_submit) * 1e3 for r in requests
                    if r.done and not r.cached], np.float64)
    out = {"misses": int(lat.size)}
    for name, q in (("p50_ms", 50), ("p99_ms", 99), ("p999_ms", 99.9)):
        out[name] = float(np.percentile(lat, q)) if lat.size else 0.0
    return out


def steady_gates(load: dict, daemon_refreshes: int, generations: int,
                 report: dict, launches: dict) -> None:
    """The [steady] gates: every arrival completed, none shed; the daemon
    refreshed and the scheduler served from enough generations; two merge
    threads ran at least one merge; pack, bm25_blocks and midgrid
    launched."""
    bad = []
    if load["completed"] != load["offered"] or load["rejected"]:
        bad.append(f"completed {load['completed']} of {load['offered']} "
                   f"offered, {load['rejected']} rejected")
    if daemon_refreshes < STEADY_MIN_REFRESHES:
        bad.append(f"{daemon_refreshes} daemon refreshes")
    if generations < STEADY_MIN_REFRESHES:
        bad.append(f"served from {generations} generations")
    if report["merge_concurrency"] != 2 or report["n_merges"] < 1:
        bad.append(f"merge_concurrency {report['merge_concurrency']}, "
                   f"n_merges {report['n_merges']}")
    for name in ("pack", "bm25_blocks", "bm25_blocks_midgrid"):
        if launches.get(name, 0) <= 0:
            bad.append(f"{name} never launched")
    if bad:
        raise AssertionError("[steady] gates: " + "; ".join(bad))


def check_no_deleted(ids, deleted) -> int:
    """No acknowledged-deleted doc among served ids; returns the ids
    checked."""
    import numpy as np
    ids = np.asarray(ids).reshape(-1)
    hit = sorted(set(ids[ids >= 0].tolist()) & set(map(int, deleted)))
    if hit:
        raise AssertionError(f"deleted docs served: {hit[:8]}")
    return int(ids.size)


def check_cache_entries(entries: dict, searcher, k: int) -> int:
    """Each result-cache entry ((query bytes, k), generation) -> (scores,
    ids) against an uncached search of ``searcher`` (the snapshot of that
    generation), 64 queries a batch: the scores bit for bit, and every
    cached id with its true score (``check_ids_by_true_score``: among
    equal scores the ids may differ, since the order segments are visited
    in, which breaks ties, follows the whole batch's bounds). Returns the
    number of entries checked."""
    import numpy as np
    import torch
    from repro_torch.core.searcher import IndexSearcher
    keys = list(entries)
    dense = IndexSearcher(readers=searcher.readers, prune=False,
                          device=searcher.device)
    for s0 in range(0, len(keys), 64):
        chunk = keys[s0:s0 + 64]
        q = np.stack([np.frombuffer(key[0][0], np.int32) for key in chunk])
        v_c = torch.from_numpy(np.stack([entries[key][0] for key in chunk]))
        i_c = torch.from_numpy(np.stack([entries[key][1] for key in chunk]))
        v, i = searcher.search_batched(q, k)
        if not torch.equal(v_c.view(torch.int32), v.view(torch.int32)):
            row = int((v_c.view(torch.int32) != v.view(torch.int32)).any(
                1).nonzero()[0])
            raise AssertionError(f"a result-cache entry of generation "
                                 f"{chunk[row][1]} differs from an uncached "
                                 f"search: {q[row].tolist()}")
        check_ids_by_true_score(dense, q, v_c, i_c, i)
    return len(keys)


def wait_for_new_generation(ix, gen0: int, timeout_s: float) -> float:
    """Wait until the snapshot ``ix`` serves is of another generation than
    ``gen0`` (the refresh daemon swaps it in); returns the seconds waited.
    Raises when that takes longer than ``timeout_s``."""
    t0 = time.perf_counter()
    while ix.searcher.generation == gen0:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"[steady] no refresh surfaced a change "
                                 f"to generation {gen0} in {timeout_s}s")
        time.sleep(0.005)
    return time.perf_counter() - t0


def _steady_churn(ix, batches, q_del, k: int):
    """The [steady] churn hook: each call is one tick that indexes the
    next batch; every STEADY_DELETE_EVERY-th tick deletes STEADY_DELETES
    docs the served snapshot returns for the pool's queries. It does not
    refresh: the daemon does. A tick that changed what is served (a flush
    or a delete) ends when the daemon has swapped in a new generation, so
    that each change surfaces in a generation of its own rather than in
    one with the next tick's. ``state.done`` is set when the last tick is
    in; ``state.lock`` is held for the length of a tick; ``state.error``
    keeps the first error a tick raised (a tick may still run on the churn
    thread after ``run_open_loop`` has returned)."""
    import threading
    import types
    import numpy as np
    state = types.SimpleNamespace(tick=0, deleted=[], t_first=None,
                                  t_last=None, waited_s=0.0, error=None,
                                  done=threading.Event(),
                                  lock=threading.Lock())

    def live():
        return {s.seg_id for s in ix.merger.live_segments()}

    def churn():
        try:
            tick()
        except Exception as e:
            state.error = state.error or e
            raise

    def tick():
        with state.lock:
            if state.tick >= len(batches):
                return
            if state.t_first is None:
                state.t_first = time.perf_counter()
            gen0, segs0 = ix.searcher.generation, live()
            ix.index_batch(batches[state.tick])
            state.tick += 1
            changed = live() != segs0
            if state.tick % STEADY_DELETE_EVERY == 0:
                _, ids = ix.searcher.search_batched(q_del, k)
                gone = set(state.deleted)
                pick = [d for d in dict.fromkeys(ids.reshape(-1).tolist())
                        if d >= 0 and d not in gone][:STEADY_DELETES]
                ix.delete(np.asarray(pick, np.int64))
                state.deleted += pick
                changed = changed or bool(pick)
            if changed:
                state.waited_s += wait_for_new_generation(
                    ix, gen0, STEADY_SURFACE_S)
            state.t_last = time.perf_counter()
            if state.tick == len(batches):
                state.done.set()
    return churn, state


def phase_steady(args, dev, card, rec, made=(), k: int = 10) -> tuple:
    """Serving while indexing, open loop: an ``Indexer`` with the refresh
    daemon (1 s) and two merge threads, a ``QueryScheduler`` (32 slots, 4
    terms, k=10, 2 ms, a ``ResultCache``) attached to it; seeded with
    STEADY_SEED_BATCHES batches, refreshed and warmed (and the warm probe
    timed once more, uncached); then Poisson arrivals at STEADY_QPS while
    the churn hook ingests
    STEADY_TICKS more batches and deletes served docs. Ticks left when
    serving ends run after it. ``made``: batches of this corpus made
    already (the durable path's). Returns (report, launches)."""
    import dataclasses
    import threading
    import numpy as np
    import torch
    from repro_torch.configs.lucene_envelope import CONFIG
    from repro_torch.core.indexer import Indexer
    from repro_torch.core.searcher import IndexSearcher
    from repro_torch.data.corpus import CW09B_SMALL, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.serving.steady import (QueryScheduler, ResultCache,
                                            run_open_loop, warm_searcher)

    class _Cache(ResultCache):
        """A ResultCache that also notes every generation a step filled
        it from: the generations the scheduler served from."""

        def __init__(self):
            super().__init__()
            self.generations = set()
            self.last_generation = 0

        def put(self, key, value):
            self.generations.add(key[1])
            self.last_generation = key[1]
            super().put(key, value)

    n_batches = STEADY_SEED_BATCHES + STEADY_TICKS
    corpus = SyntheticCorpus(dataclasses.replace(
        CW09B_SMALL, n_docs=n_batches * args.batch_docs),
        doc_buffer_len=CONFIG.doc_len)
    t0 = time.perf_counter()
    batches = (list(made[:n_batches]) if len(made) >= n_batches else
               serve.generate_batches(corpus, n_batches, args.batch_docs))
    rep = {"generate_s": time.perf_counter() - t0,
           "docs": n_batches * args.batch_docs}
    rng = np.random.default_rng(0)
    vocab = np.unique(batches[0][:32])[1:]
    pool = [rng.choice(vocab, 4, replace=False).astype(np.int32)
            for _ in range(STEADY_POOL)]
    q_pool = np.stack(pool)
    refreshes = []            # (thread name, seconds) of every refresh
    snapshots = {}            # generation -> searcher, the last few
    swapped = set()           # every generation a refresh swapped in

    def on_refresh(s):
        refreshes.append((threading.current_thread().name,
                          ix.stats.last_refresh_s))
        swapped.add(s.generation)
        snapshots[s.generation] = s
        while len(snapshots) > 4:
            snapshots.pop(next(iter(snapshots)))
    with rec:
        _build.reset_launches()
        ix = Indexer(cfg=CONFIG, device=dev, refresh_every=1.0,
                     merge_threads=2)
        try:
            t0 = time.perf_counter()
            for b in batches[:STEADY_SEED_BATCHES]:
                ix.index_batch(b)
            searcher = ix.refresh()
            rep["seed_s"] = time.perf_counter() - t0
            cache = _Cache()
            sched = QueryScheduler(searcher=searcher, slots=32, max_terms=4,
                                   k=k, max_wait_ms=2.0, cache=cache,
                                   device=dev)
            ix.attach_serving(sched)
            snapshots[searcher.generation] = searcher
            ix.on_refresh.append(on_refresh)
            t0 = time.perf_counter()
            warm_searcher(searcher, pool, 32, 4, k)
            rep["warm_s"] = time.perf_counter() - t0
            rep["probe"] = probe = probe_qps(searcher, pool, 32, 4, k)
            rep["qps_target"] = qps = STEADY_QPS
            churn, state = _steady_churn(
                ix, batches[STEADY_SEED_BATCHES:], q_pool[:32], k)
            rep["duration_s"] = STEADY_SECONDS
            load = run_open_loop(sched, pool, qps, STEADY_SECONDS, seed=0,
                                 churn=churn,
                                 churn_interval_s=STEADY_TICK_GAP)
            with state.lock:          # the tick in flight, if any
                rep["ticks_under_serving"] = state.tick
            # the last generation served, and its snapshot
            gen = cache.last_generation
            served_searcher = snapshots.get(gen)
            while state.tick < STEADY_TICKS:
                churn()
            if not state.done.wait(timeout=60):
                raise AssertionError("[steady] the churn never finished")
            if state.error is not None:
                raise state.error
            ix.merge_scheduler.drain()
            report = ix.envelope_report()
        finally:
            ix.close()
        launches = dict(_build.LAUNCHES)
    daemon = [s for name, s in refreshes if name == "nrt-refresh"]
    rep.update(load.row(), daemon_refreshes=len(daemon),
               refresh_mean_s=float(np.mean(daemon)) if daemon else 0.0,
               refresh_max_s=float(np.max(daemon)) if daemon else 0.0,
               generations_served=len(cache.generations),
               generations_swapped=len(swapped),
               n_merges=report["n_merges"],
               merge_wall_s=report["merge_wall_s"],
               merge_concurrency=report["merge_concurrency"],
               cache=cache.report(), deleted=len(state.deleted),
               surface_wait_s=state.waited_s,
               launches=launches, serve_steps=report["serve_steps"],
               serve_cached=report["serve_cached"])
    ticked = state.t_last - state.t_first if state.t_last else 0.0
    rep["ticks_s"] = ticked
    rep["docs_per_s_ingest_under_serving"] = (
        rep["ticks_under_serving"] * args.batch_docs / ticked
        if ticked > 0 else 0.0)
    hit_rate = load.cached / max(load.completed, 1)
    rep["miss_latency"] = miss = miss_latency_ms(load.requests)
    print(f"[steady] on {card}: open loop at {qps:.2f} QPS offered "
          f"(fixed; the seeded snapshot serves {probe['qps']:.2f} QPS "
          f"closed loop without a cache: {probe['queries']} probe queries "
          f"in {probe['s']:.3f}s) for {rep['duration_s']:.1f}s: "
          f"{load.completed} of {load.offered} completed, {load.rejected} "
          f"rejected, achieved {load.qps_achieved:.2f} QPS in "
          f"{load.wall_s:.2f}s; latency p50 {load.p50_ms:.2f} ms p99 "
          f"{load.p99_ms:.2f} ms p999 {load.p999_ms:.2f} ms; queue depth "
          f"mean {load.mean_queue_depth:.2f} max {load.max_queue_depth}; "
          f"cache hit rate {hit_rate:.4f} ({load.cached} hits); the "
          f"{miss['misses']} misses alone: p50 {miss['p50_ms']:.2f} ms p99 "
          f"{miss['p99_ms']:.2f} ms p999 {miss['p999_ms']:.2f} ms",
          flush=True)
    print(f"[steady] on {card}: {rep['docs']} docs ({STEADY_SEED_BATCHES} "
          f"seed batches + {STEADY_TICKS} ticks, {rep['ticks_under_serving']}"
          f" under serving over {ticked:.1f}s, {rep['deleted']} deletes, "
          f"{rep['surface_wait_s']:.1f}s of it waiting for changes to "
          f"surface); ingest to searchable under serving "
          f"{rep['docs_per_s_ingest_under_serving']:.0f} docs/s; "
          f"{rep['daemon_refreshes']} daemon refreshes (each a device-wide "
          f"synchronize), mean {rep['refresh_mean_s']:.3f}s max "
          f"{rep['refresh_max_s']:.3f}s; served from "
          f"{rep['generations_served']} generations of "
          f"{rep['generations_swapped']} swapped in; {rep['n_merges']} "
          f"merges on {rep['merge_concurrency']} threads, "
          f"{rep['merge_wall_s']:.2f}s merge wall; seed "
          f"{rep['seed_s']:.2f}s, warm {rep['warm_s']:.2f}s; launches "
          f"{launches}", flush=True)
    steady_gates(rep, rep["daemon_refreshes"], rep["generations_served"],
                 report, launches)
    # after close(): one more refresh; the final snapshot is exact
    final = ix.refresh()
    dense = IndexSearcher(readers=final.readers, prune=False, device=dev)
    q = q_pool[:32]
    v_all, i_all = final.search_batched(q_pool, k)
    v_p, i_p = v_all[:32], i_all[:32]
    v_d, i_d = dense.search_batched(q, k)
    if not torch.equal(v_p.view(torch.int32), v_d.view(torch.int32)):
        raise AssertionError("[steady] pruned != exhaustive on the final "
                             "snapshot")
    check_ids_by_true_score(dense, q, v_p, i_p, i_d)
    check_no_deleted(i_all, state.deleted)
    if final.n_docs != rep["docs"] - len(state.deleted):
        raise AssertionError(f"[steady] the final snapshot holds "
                             f"{final.n_docs} docs, not {rep['docs']} - "
                             f"{len(state.deleted)} deleted")
    if served_searcher is None:
        raise AssertionError(f"[steady] the snapshot of generation {gen}, "
                             f"the last served, is not at hand")
    with cache._lock:
        entries = {key: v for key, v in cache._store.items()
                   if key[1] == gen}
    rep["cache_entries_checked"] = check_cache_entries(entries,
                                                       served_searcher, k)
    print(f"[steady] checks after close() and one more refresh: final "
          f"snapshot {final.n_docs} docs, pruned == exhaustive with true "
          f"scores on 32 queries, no deleted doc among the pool's top-{k}, "
          f"{rep['cache_entries_checked']} cache entries of generation "
          f"{gen} == uncached searches (scores bit for bit, ids by true "
          f"score)", flush=True)
    del ix, sched, searcher, served_searcher, final, dense, cache, batches
    snapshots.clear()
    return rep, launches


def fleet_deletes(tokens, terms, base: int, n: int):
    """``n`` doc ids of a shard's first batch to delete: the docs that hold
    the most of ``terms`` (the first serve batch's), the lower row first
    among equals; row r of the batch is doc ``base + r``. Deletes picked
    so the served batches would return them if they were not honoured."""
    import numpy as np
    hits = np.isin(np.asarray(tokens), np.asarray(terms)).sum(axis=1)
    rows = np.argsort(-hits, kind="stable")[:n]
    return np.sort(base + rows.astype(np.int64))


def fleet_gates(here: dict, children: dict, shed: int, failovers: int,
                degraded_served: int) -> None:
    """The [fleet] gates on what the counted run recorded: unpack, and
    bm25_blocks or midgrid, launched in this process (the writers and the
    in-process replicas) and in each replica process (``children``:
    replica id -> its launch counts), pack in this process; the
    quarantined replica served none of the degraded batches, at least one
    pick failed over to its peer, and no shard was served degraded."""
    bad = []
    for who, n in [("this process", here)] + sorted(children.items()):
        if n.get("unpack", 0) <= 0:
            bad.append(f"{who}: unpack never launched")
        if n.get("bm25_blocks", 0) + n.get("bm25_blocks_midgrid", 0) <= 0:
            bad.append(f"{who}: neither bm25_blocks nor midgrid launched")
    if here.get("pack", 0) <= 0:
        bad.append("this process: pack never launched")
    if shed:
        bad.append(f"the quarantined replica served {shed} batches")
    if failovers < 1:
        bad.append("no pick failed over to the healthy peer")
    if degraded_served:
        bad.append(f"{degraded_served} shards served degraded")
    if bad:
        raise AssertionError("[fleet] gates: " + "; ".join(bad))


def _rot(directory, name: str) -> None:
    """Flip one byte in the middle of ``name`` on ``directory``."""
    data = bytearray(directory.read_file(name))
    data[len(data) // 2] ^= 0xFF
    directory.write_file(name, bytes(data))


def phase_fleet(args, dev, card, rec, made=(), k: int = 10) -> tuple:
    """The replicated fleet on the card (phase 14 of the module
    docstring). Counted run: FLEET_SHARDS range-shard writers (full
    CONFIG, a ``CommitPublisher`` each) index FLEET_BATCHES batches and
    commit; shard 0's replicas are ``ReplicaSyncer``s in this process,
    shard 1's ``RemoteReplica`` processes, all on ``dev``; first sync;
    one more batch and FLEET_DELETES deletes a shard, a second commit,
    delta sync; FLEET_SERVE_BATCHES closed-loop batches of 32 queries
    through ``FleetSearcher``; a rotted ``.pst`` on an in-process replica
    found by a sweep and quarantined, FLEET_DEGRADED_BATCHES batches,
    ``repair``; a rotted ``.doc`` on a replica process healed by
    ``anti_entropy``; FLEET_HEALED_BATCHES batches after each heal. Then,
    not counted, every served batch against the union oracle (values bit
    for bit, ids by true score, no deleted doc). ``made``: batches of
    this corpus made already. Returns (report, launches of this process
    and the replica processes, summed)."""
    import dataclasses
    import shutil
    import numpy as np
    from repro_torch.configs.lucene_envelope import CONFIG
    from repro_torch.data.corpus import CW09B_SMALL, SyntheticCorpus
    from repro_torch.launch import serve

    per = FLEET_BATCHES + 1
    n_batches = FLEET_SHARDS * per
    corpus = SyntheticCorpus(dataclasses.replace(
        CW09B_SMALL, n_docs=n_batches * args.batch_docs),
        doc_buffer_len=CONFIG.doc_len)
    t0 = time.perf_counter()
    batches = (list(made[:n_batches]) if len(made) >= n_batches else
               serve.generate_batches(corpus, n_batches, args.batch_docs))
    docs = min(FLEET_BATCH_DOCS, args.batch_docs)
    batches = [b[:docs] for b in batches]
    rep = {"generate_s": time.perf_counter() - t0,
           "docs_per_shard": FLEET_BATCHES * docs,
           "delta_docs_per_shard": docs}
    rng = np.random.default_rng(0)
    vocab = np.unique(batches[0][:32])[1:]
    n_q = 32 * (FLEET_SERVE_BATCHES + FLEET_DEGRADED_BATCHES
                + 2 * FLEET_HEALED_BATCHES)
    qbatches = list(np.stack([rng.choice(vocab, 4, replace=False)
                              for _ in range(n_q)]).astype(np.int32)
                    .reshape(-1, 32, 4))
    tmp = ROOT / "build" / f"chip_smoke_fleet_{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        return _fleet_run(dev, card, rec, batches, qbatches, tmp, rep, k)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _fleet_run(dev, card, rec, batches, qbatches, tmp, rep, k):
    """[fleet]'s counted run and checks, in ``tmp`` (see
    ``phase_fleet``)."""
    import numpy as np
    import torch
    from repro_torch.configs.lucene_envelope import CONFIG
    from repro_torch.core.indexer import Indexer
    from repro_torch.core.searcher import ReaderCache
    from repro_torch.kernels import _build
    from repro_torch.replication import (CommitPublisher, FleetSearcher,
                                         RemoteReplica, ReplicaSyncer)
    from repro_torch.storage import ChecksumScrubber, FSDirectory, open_latest

    per = FLEET_BATCHES + 1
    queries = iter(qbatches)
    writers, pubs, shards, remotes = [], [], [], []
    served = []               # (label, q, vals, ids), checked after the run
    syncs = {}                # replica id -> {"first"/"delta": summary}

    def sync_all(label):
        for si, group in enumerate(shards):
            for r in group:
                t = time.perf_counter()
                out = r.sync_once()
                wall = time.perf_counter() - t
                if out is None:
                    raise AssertionError(f"[fleet] {r.replica_id}: nothing "
                                         f"to sync at the {label} sync")
                if isinstance(r, RemoteReplica):
                    # the child's ack, relayed into the writer's ledger
                    pubs[si].ack(r.replica_id, out["gen"], out["lag_s"],
                                 out["bytes"], files_shipped=out["files"])
                syncs.setdefault(r.replica_id, {})[label] = dict(
                    out, wall_s=wall)

    def serve_batches(label, n, lat=None):
        for _ in range(n):
            q = next(queries)
            t = time.perf_counter()
            v, i = fleet.search_batched(q, k)
            if lat is not None:
                lat.append(time.perf_counter() - t)
            served.append((label, q, v, i))

    try:
        _build.reset_launches()
        with rec:
            t0 = time.perf_counter()
            for si in range(FLEET_SHARDS):
                d = FSDirectory(str(tmp / f"s{si}" / "writer"))
                pub = CommitPublisher(d)
                ix = Indexer(cfg=CONFIG, device=dev, target_dir=d,
                             publisher=pub, doc_base=si * FLEET_RANGE)
                for b in batches[si * per:si * per + FLEET_BATCHES]:
                    ix.index_batch(b)
                ix.commit()
                writers.append(ix)
                pubs.append(pub)
            rep["writers_s"] = time.perf_counter() - t0
            for si in range(FLEET_SHARDS):
                src = tmp / f"s{si}" / "writer"
                paths = [tmp / f"s{si}" / f"r{ri}"
                         for ri in range(FLEET_REPLICAS)]
                group = []
                for ri, path in enumerate(paths):
                    peers = [p for p in paths if p != path]
                    if si == 0:
                        r = ReplicaSyncer(
                            FSDirectory(str(path)), FSDirectory(str(src)),
                            peers=[FSDirectory(str(p)) for p in peers],
                            replica_id=f"s{si}r{ri}", publisher=pubs[si],
                            device=dev)
                    else:
                        r = RemoteReplica(f"s{si}r{ri}", path, src,
                                          peer_paths=peers, device=dev,
                                          timeout_s=FLEET_TIMEOUT_S).start()
                        remotes.append(r)
                        pubs[si].register(r.replica_id)
                    group.append(r)
                shards.append(group)
            sync_all("first")
            fleet = FleetSearcher(shards, device=dev)
            deleted = []
            t0 = time.perf_counter()
            for si, ix in enumerate(writers):
                ids = fleet_deletes(batches[si * per], qbatches[0],
                                    si * FLEET_RANGE, FLEET_DELETES)
                ix.index_batch(batches[si * per + FLEET_BATCHES])
                ix.delete(ids)
                deleted += ids.tolist()
                ix.commit()
            rep["delta_commit_s"] = time.perf_counter() - t0
            sync_all("delta")
            lat = []
            serve_batches("closed loop", FLEET_SERVE_BATCHES, lat)
            closed = fleet.report()
            # failover: bit rot on an in-process replica's disk, found by a
            # sweep, quarantined; its traffic sheds to the healthy peer
            bad = shards[0][0]
            victim = next(n for n in sorted(bad.directory.list_files())
                          if n.endswith(".pst"))
            _rot(bad.directory, victim)
            t0 = time.perf_counter()
            found = ChecksumScrubber(bad.directory).sweep()
            rep["sweep_ms"] = (time.perf_counter() - t0) * 1e3
            if victim not in found:
                raise AssertionError(f"[fleet] the sweep missed {victim}: "
                                     f"{found}")
            base = bad.quarantine(victim)
            if bad.healthy or fleet.degraded:
                raise AssertionError("[fleet] quarantine left the replica "
                                     "healthy or the fleet degraded")
            before = fleet.report()
            serve_batches("degraded", FLEET_DEGRADED_BATCHES)
            after = fleet.report()
            t0 = time.perf_counter()
            fix = bad.repair(base)
            rep["repair_ms"] = (time.perf_counter() - t0) * 1e3
            if fix["files"] < 1 or not bad.healthy:
                raise AssertionError(f"[fleet] repair did not heal "
                                     f"{bad.replica_id}: {fix}")
            serve_batches("repaired", FLEET_HEALED_BATCHES)
            # a second rot, on a replica process's disk: anti-entropy
            pbad = shards[1][0]
            pdir = FSDirectory(str(tmp / "s1" / "r0"))
            victim2 = next(n for n in sorted(pdir.list_files())
                           if n.endswith(".doc"))
            _rot(pdir, victim2)
            t0 = time.perf_counter()
            healed = pbad.anti_entropy()
            rep["anti_entropy_ms"] = (time.perf_counter() - t0) * 1e3
            if victim2 not in healed["corrupt"] or not pbad.healthy:
                raise AssertionError(f"[fleet] anti_entropy did not heal "
                                     f"{victim2} on {pbad.replica_id}: "
                                     f"{healed}")
            serve_batches("anti-entropy", FLEET_HEALED_BATCHES)
            here = dict(_build.LAUNCHES)
            children = {r.replica_id: r.report() for r in remotes}
        ledgers = [pub.report() for pub in pubs]
        final = fleet.report()
    finally:
        for r in remotes:
            r.close()
        for ix in writers:
            ix.close()
    launches = dict(here)
    for c in children.values():
        for name, n in c["launches"].items():
            launches[name] += n
    shed = (after["served"].get(bad.replica_id, 0)
            - before["served"].get(bad.replica_id, 0))
    lat = np.asarray(lat)
    rep.update(qps=32 * lat.size / lat.sum(),
               batch_p50_ms=float(np.percentile(lat, 50)) * 1e3,
               batch_max_ms=float(lat.max()) * 1e3, syncs=syncs,
               closed_loop=closed, fleet=final, ledgers=ledgers,
               launches_here=here, deleted=deleted,
               launches_children={rid: c["launches"]
                                  for rid, c in children.items()},
               repair=fix, anti_entropy=healed, quarantined=victim,
               degraded_failovers=after["failovers"] - before["failovers"])
    for rid, s in sorted(syncs.items()):
        kind = "in-process" if rid.startswith("s0") else "process"
        print(f"[fleet] on {card}: replica {rid} ({kind}, {dev}): "
              + "; ".join(f"{label} sync {o['wall_s']:.2f}s wall, lag "
                          f"{o['lag_s']:.3f}s, {o['files']} files, "
                          f"{o['bytes']} bytes" for label, o in s.items()),
              flush=True)
    print(f"[fleet] on {card}: {FLEET_SHARDS} shards x {FLEET_REPLICAS} "
          f"replicas, {rep['docs_per_shard']} + {rep['delta_docs_per_shard']}"
          f" docs and {FLEET_DELETES} deletes a shard (writers "
          f"{rep['writers_s']:.2f}s to the first commit, "
          f"{rep['delta_commit_s']:.2f}s to the second); {rep['qps']:.1f} QPS"
          f" closed loop over {lat.size} batches of 32 (k={k}), batch p50 "
          f"{rep['batch_p50_ms']:.2f} ms max {rep['batch_max_ms']:.2f} ms; "
          f"shards visited {closed['shards_visited']} skipped "
          f"{closed['shards_skipped']}; batches served per replica (all "
          f"phases) {final['served']}", flush=True)
    print(f"[fleet] on {card}: failover: {victim} rotted on "
          f"{bad.replica_id}, the sweep found it in {rep['sweep_ms']:.2f} "
          f"ms, {rep['degraded_failovers']} failovers over "
          f"{FLEET_DEGRADED_BATCHES} degraded batches, none served by it; "
          f"repair re-fetched {fix['files']} file(s) ({fix['bytes']} bytes) "
          f"in {rep['repair_ms']:.2f} ms; {victim2} rotted on "
          f"{pbad.replica_id}, anti_entropy healed it in "
          f"{rep['anti_entropy_ms']:.2f} ms; launches here {here}, in the "
          f"replica processes {rep['launches_children']}, summed "
          f"{launches}", flush=True)
    fleet_gates(here, rep["launches_children"], shed,
                rep["degraded_failovers"], final["degraded_served"])

    # --- checks (not counted): every served batch against the union ---
    t0 = time.perf_counter()
    segs = []
    for si in range(FLEET_SHARDS):
        segs += open_latest(FSDirectory(str(tmp / f"s{si}" / "writer")),
                            device=dev)[1]
    oracle = ReaderCache(prune=False, device=dev).refresh(segs)
    for bi, (label, q, v, i) in enumerate(served):
        v_o, i_o = oracle.search_batched(q, k)
        if not torch.equal(v.view(torch.int32), v_o.view(torch.int32)):
            raise AssertionError(f"[fleet] batch {bi} ({label}): values != "
                                 f"the union oracle")
        if not bool(torch.isfinite(v).all()) or tuple(v.shape) != (32, k):
            raise AssertionError(f"[fleet] batch {bi} ({label}): malformed")
        check_ids_by_true_score(oracle, q, v, i, i_o)
        check_no_deleted(i, deleted)
    rep["checked_batches"] = len(served)
    rep["oracle_docs"] = oracle.n_docs
    print(f"[fleet] checks: all {len(served)} served batches (closed loop, "
          f"degraded, after repair, after anti-entropy) == the union oracle "
          f"over {oracle.n_docs} live docs (values bit for bit, ids by true "
          f"score), no deleted doc served; the publishers' ledgers: "
          f"{[l['replicas_current'] for l in ledgers]} replicas current, "
          f"{sum(l['bytes_shipped_total'] for l in ledgers)} bytes shipped "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    del oracle, segs, fleet, shards, writers, served
    return rep, launches


MESH_WORLD = 4                      # [mesh]'s ranks, all on this card, as
MESH_SHAPE = {"data": 2, "model": 2}   # the JAX debug mesh lays them out
MESH_STEPS = 3                      # timed steps a payload, after the first
MESH_TIMEOUT_S = 300.0              # the longest the world may take
MESH_MERGE = (4, 32, 10)            # (shards, queries, k) of the merge check
MESH_FIELDS = ("packed_docs", "bw_docs", "packed_pos", "bw_pos")


def mesh_digests(out: dict) -> dict:
    """Field -> SHA-256 of its dtype, shape and bytes, for every output of
    one rank's indexing step (``make_index_step``): two ranks' outputs
    are bit-equal when their digests are."""
    import hashlib
    tensors = {f"run.{f}": getattr(out["run"], f) for f in out["run"]._fields}
    tensors.update({f"stats.{f}": t
                    for f, t in out["stats"]._asdict().items()})
    tensors.update({f: out[f] for f in MESH_FIELDS})
    dig = {}
    for name, t in tensors.items():
        a = t.detach().cpu().contiguous().numpy()
        h = hashlib.sha256(f"{a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
        dig[name] = h.hexdigest()
    dig["packed_bytes"] = repr(float(out["packed_bytes"]))
    return dig


def mesh_merge_inputs(rng):
    """Per-shard (S, B, k) partials as ``FleetSearcher`` passes them, with
    ties across shards (values on a coarse grid) and -1 ids in the tail."""
    import numpy as np
    S, B, k = MESH_MERGE
    vals = np.sort(rng.integers(0, 40, (S, B, k)).astype(np.float32) / 4,
                   axis=2)[:, :, ::-1].copy()
    ids = rng.permutation(S * B * k).reshape(S, B, k).astype(np.int64)
    ids[:, :, -2:] = -1
    vals[:, :, -2:] = 0
    return vals, ids, k


def mesh_gates(ranks: list, want: list, world1: dict, want1: dict) -> None:
    """The [mesh] gates on the world's ranks (each rank's report from
    ``_mesh_rank``) against the plain loopback's digests ``want``, by
    rank, and on world 1's report against the plain path's ``want1``:
    every output bit-equal; packed2 == raw; every term on model index m
    is m mod the model axis; pack launched in each counted step; the
    shard-mesh merge == the host merge; sent == recv + dropped over the
    world."""
    bad = []
    runs = [(f"rank {r}", rep, ref) for r, (rep, ref)
            in enumerate(zip(ranks, want))] + [("world 1", world1, want1)]
    for who, rep, ref in runs:
        diff = sorted(f for f in ref if rep["digests"].get(f) != ref[f])
        if diff:
            bad.append(f"{who}: {diff} differ from the plain path")
        if not rep.get("packed2_eq_raw", True):
            bad.append(f"{who}: packed2 != raw")
        if not rep["owned"]:
            bad.append(f"{who}: a term off its owner")
        if rep["launches"].get("pack", 0) <= 0:
            bad.append(f"{who}: pack never launched")
        if not rep["merge_eq_host"]:
            bad.append(f"{who}: the mesh merge != the host merge")
    tot = {f: sum(r["stats"][f] for r in ranks)
           for f in ("sent", "recv", "dropped")}
    if tot["sent"] != tot["recv"] + tot["dropped"]:
        bad.append(f"sent {tot['sent']} != recv {tot['recv']} + dropped "
                   f"{tot['dropped']}")
    if bad:
        raise AssertionError("[mesh] gates: " + "; ".join(bad))


def _timed_steps(step, mesh, tok, barrier) -> dict:
    """MESH_STEPS runs of ``step`` on ``tok``: the three stages timed
    apart (send, the all-to-all of every buffer, receive and pack), then
    the whole step; each after a barrier across the world and a
    synchronize. Medians in ms, and the bytes the all-to-all moved."""
    t = {"send_ms": [], "exchange_ms": [], "receive_ms": [], "step_ms": []}
    dev = tok.device
    for _ in range(MESH_STEPS):
        barrier()
        _sync(dev)
        t0 = time.perf_counter()
        sent = step.send(tok)
        _sync(dev)
        t1 = time.perf_counter()
        received = tuple(mesh.all_to_all(b, "model") for b in sent.buffers)
        _sync(dev)
        t2 = time.perf_counter()
        step.receive(sent, received)
        _sync(dev)
        t3 = time.perf_counter()
        barrier()
        _sync(dev)
        t4 = time.perf_counter()
        step(tok)
        _sync(dev)
        t5 = time.perf_counter()
        for key, dt in (("send_ms", t1 - t0), ("exchange_ms", t2 - t1),
                        ("receive_ms", t3 - t2), ("step_ms", t5 - t4)):
            t[key].append(dt * 1e3)
    out = {key: statistics.median(v) for key, v in t.items()}
    out["shuffle_bytes"] = sum(b.numel() * b.element_size()
                               for b in sent.buffers)
    out["staged"] = mesh.host_staged("model", sent.buffers[0])
    return out


def _step_checks(out, mesh) -> dict:
    """What one rank can check of its own step's outputs: its terms'
    owner (the model index), its stats, its term count and bytes."""
    run = out["run"]
    terms = run.terms_unique[:int(run.n_terms)]
    n = mesh.axis_size("model")
    return {"owned": bool((terms % n == mesh.axis_index("model")).all()),
            "n_terms": int(run.n_terms),
            "stats": {f: int(v) for f, v in out["stats"]._asdict().items()},
            "packed_bytes": float(out["packed_bytes"])}


def _same_outputs(a: dict, b: dict) -> bool:
    import torch
    return all(torch.equal(getattr(a["run"], f), getattr(b["run"], f))
               for f in a["run"]._fields) and all(
        torch.equal(a[f], b[f]) for f in MESH_FIELDS)


def _mesh_merge_check(mesh, dev) -> bool:
    """``merge_topk_sharded`` over ``mesh``'s ``shard`` axis == the host
    merge, values bit for bit and ids, on ``mesh_merge_inputs``."""
    import numpy as np
    import torch
    from repro_torch.replication import merge_topk_sharded
    vals, ids, k = mesh_merge_inputs(np.random.default_rng(3))
    mv, mi = merge_topk_sharded(vals, ids, k, mesh=mesh)
    hv, hi = merge_topk_sharded(vals, ids, k)
    return bool(torch.equal(mv.view(torch.int32), hv.view(torch.int32))
                and torch.equal(mi, hi))


def _mesh_rank(rank: int, world: int, tmp: str, cfg, device: str) -> dict:
    """One rank of [mesh]'s world (``distributed.spawn_world``, gloo, on
    ``device``: on ``cuda:0`` it loads the kernels this script built):
    runs the counted packed2 step on its block, raw on the same block,
    checks, times, and merges over a (4,) ``shard`` mesh. Returns numpy
    and plain Python."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.indexer import make_index_step
    from repro_torch.distributed import make_debug_mesh, make_mesh
    from repro_torch.kernels import _build
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _build.lib("postings_pack")
    mesh = make_debug_mesh(MESH_SHAPE["data"], MESH_SHAPE["model"])
    shard = make_mesh({"shard": world})
    tok = torch.from_numpy(np.load(Path(tmp) / f"block{rank}.npy")).to(dev)
    steps = {p: make_index_step(dataclasses.replace(cfg, shuffle_payload=p),
                                mesh, cfg.doc_len, device=dev)
             for p in ("packed2", "raw")}
    dist.barrier()
    _build.reset_launches()
    out = steps["packed2"](tok)
    _sync(dev)
    rep = {"coords": mesh.coords, "launches": dict(_build.LAUNCHES)}
    raw = steps["raw"](tok)
    rep.update(_step_checks(out, mesh), digests=mesh_digests(out),
               packed2_eq_raw=_same_outputs(out, raw))
    del out, raw
    rep["timing"] = {p: _timed_steps(s, mesh, tok, dist.barrier)
                     for p, s in steps.items()}
    rep["merge_eq_host"] = _mesh_merge_check(shard, dev)
    return rep


def phase_mesh(dev, card, rec) -> tuple:
    """The multi-device indexing step at full CONFIG width (phase 13 of
    the module docstring; the world's ranks get CONFIG from this
    process). On a CPU ``dev`` (a rehearsal) world 1 runs over gloo.
    Returns (report, launches of this process and of the world's
    processes, summed)."""
    import dataclasses
    import shutil
    import threading
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.lucene_envelope import CONFIG
    from repro_torch.core.indexer import index_step_loopback, make_index_step
    from repro_torch.data.corpus import CW09B_SMALL, SyntheticCorpus
    from repro_torch.distributed import (init_world, make_debug_mesh,
                                         make_mesh, spawn_world)
    from repro_torch.kernels import _build

    cfg = CONFIG
    D, L = cfg.docs_per_shard, cfg.doc_len
    corpus = SyntheticCorpus(dataclasses.replace(
        CW09B_SMALL, n_docs=MESH_WORLD * D), doc_buffer_len=L)
    blocks = [corpus.batch(r, D) for r in range(MESH_WORLD)]
    tmp = ROOT / "build" / f"chip_smoke_mesh_{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for r, b in enumerate(blocks):
        np.save(tmp / f"block{r}.npy", b)
    # one host, no network: gloo and NCCL talk over the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    rep = {"tokens_per_rank": D * L, "world": MESH_WORLD,
           "shape": MESH_SHAPE}
    try:
        # the world of 4 on this card, while this process runs the plain
        # loopback over the same blocks on the CPU
        box = {}

        def run_world():
            try:
                box["ranks"] = spawn_world(
                    _mesh_rank, MESH_WORLD, tmp / "world", backend="gloo",
                    args=(str(tmp), cfg, str(dev)),
                    timeout_s=MESH_TIMEOUT_S)
            except Exception as e:    # raised below, in this thread
                box["error"] = e
        t0 = time.perf_counter()
        th = threading.Thread(target=run_world, name="mesh-world")
        th.start()
        t1 = time.perf_counter()
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, min(threads, 4)))   # cores for the world
        try:
            want = [mesh_digests(o) for o in index_step_loopback(
                cfg, MESH_SHAPE, blocks, L, device="cpu")]
        finally:
            torch.set_num_threads(threads)
        rep["loopback_s"] = time.perf_counter() - t1
        th.join(MESH_TIMEOUT_S + 60)
        if th.is_alive() or "ranks" not in box:
            raise AssertionError(f"[mesh] the world of {MESH_WORLD} failed: "
                                 f"{box.get('error', 'no result')}")
        ranks = box["ranks"]
        rep["world_s"] = time.perf_counter() - t0
        # world 1 in this process (over NCCL on the card): the counted run
        # of this process, on block 0, held against the plain path
        t0 = time.perf_counter()
        backend = "nccl" if dev.type == "cuda" else "gloo"
        init_world(0, 1, tmp / "world1_rendezvous", backend=backend)
        try:
            mesh = make_debug_mesh(1, 1)
            shard = make_mesh({"shard": 1})
            step = make_index_step(cfg, mesh, L, device=dev)
            tok = torch.from_numpy(blocks[0]).to(dev)
            with rec:
                _build.reset_launches()
                out = step(tok)
                _sync(dev)
                here = dict(_build.LAUNCHES)
            one = _timed_steps(step, mesh, tok, dist.barrier)
            world1 = dict(_step_checks(out, mesh), digests=mesh_digests(out),
                          launches=here,
                          merge_eq_host=_mesh_merge_check(shard, dev))
        finally:
            dist.destroy_process_group()
        rep["world1_s"] = time.perf_counter() - t0
        del out
        t0 = time.perf_counter()
        want1 = mesh_digests(index_step_loopback(
            cfg, {"data": 1, "model": 1}, blocks[:1], L, device="cpu")[0])
        rep["plain1_s"] = time.perf_counter() - t0
        mesh_gates(ranks, want, world1, want1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    children = {f"rank{r}": rk["launches"] for r, rk in enumerate(ranks)}
    rep.update(ranks=[{k: v for k, v in rk.items() if k != "digests"}
                      for rk in ranks],
               world1={"timing": one, "backend": backend,
                       **{k: v for k, v in world1.items()
                          if k != "digests"}},
               launches_here=here,
               launches_children=children)
    for r, rk in enumerate(ranks):
        t = rk["timing"]
        fewer = 1 - t["packed2"]["shuffle_bytes"] / t["raw"]["shuffle_bytes"]
        print(f"[mesh] on {card}: world {MESH_WORLD} rank {r} "
              f"{rk['coords']} (gloo on {dev}, the exchange staged through "
              f"host memory: {t['packed2']['staged']}): step "
              f"{t['packed2']['step_ms']:.3f} ms packed2 / "
              f"{t['raw']['step_ms']:.3f} ms raw (median of {MESH_STEPS}, "
              f"synchronized); stages packed2 send "
              f"{t['packed2']['send_ms']:.3f} + exchange "
              f"{t['packed2']['exchange_ms']:.3f} + receive and pack "
              f"{t['packed2']['receive_ms']:.3f} ms, the exchange "
              f"{t['packed2']['exchange_ms'] / t['packed2']['step_ms']:.3f} "
              f"of the step; shuffle bytes a step raw "
              f"{t['raw']['shuffle_bytes']} packed2 "
              f"{t['packed2']['shuffle_bytes']} ({fewer:.3f} fewer); "
              f"sent {rk['stats']['sent']} recv {rk['stats']['recv']} "
              f"dropped {rk['stats']['dropped']}; {rk['n_terms']} terms; "
              f"packed_bytes {rk['packed_bytes']:.0f}; pack launches "
              f"{rk['launches']['pack']}", flush=True)
    tot = {f: sum(rk["stats"][f] for rk in ranks)
           for f in ("sent", "recv", "dropped")}
    print(f"[mesh] on {card}: world {MESH_WORLD} {MESH_SHAPE} at {cfg.name}"
          f" width ({D} docs x {L} tokens a rank, CW09B_SMALL's law): every "
          f"rank's outputs == the plain loopback on the CPU bit for bit "
          f"(loopback {rep['loopback_s']:.1f}s beside the world's "
          f"{rep['world_s']:.1f}s); packed2 == raw; sent {tot['sent']} == "
          f"recv {tot['recv']} + dropped {tot['dropped']}; every term on "
          f"its owner; merge_topk_sharded over a ({MESH_WORLD},) shard mesh"
          f" == the host merge on every rank", flush=True)
    print(f"[mesh] on {card}: world 1 (1, 1) over {backend} in this "
          f"process: "
          f"step {one['step_ms']:.3f} ms packed2 (send {one['send_ms']:.3f}"
          f" + exchange {one['exchange_ms']:.3f} + receive and pack "
          f"{one['receive_ms']:.3f} ms; staged {one['staged']}), sent "
          f"{world1['stats']['sent']} dropped {world1['stats']['dropped']}"
          f"; == the plain path on the CPU bit for bit ({rep['plain1_s']:.1f}"
          f"s); merge over a (1,) shard mesh == host; launches {here}",
          flush=True)
    launches = dict(here)
    for c in children.values():
        for name, n in c.items():
            launches[name] += n
    return rep, launches


def start_examples() -> tuple:
    """Start ``examples/torch_*.py`` on the card, as subprocesses started
    together; ``finish_examples`` waits for them."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return time.perf_counter(), {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name),
         *EXAMPLE_ARGS.get(name, ())], cwd=str(ROOT),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in EXAMPLES}


def finish_examples(started: tuple, card) -> dict:
    """Wait for the examples ``start_examples`` started (300 s each at
    most; one that overruns is killed, as are the rest when one fails to
    finish): each must exit 0."""
    t0, procs = started
    out = {}
    try:
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=300)
            out[name] = {"rc": proc.returncode,
                         "tail": log.splitlines()[-3:]}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    secs = time.perf_counter() - t0
    bad = {n: o for n, o in out.items() if o["rc"] != 0}
    if bad:
        raise AssertionError(f"[examples] failed: {bad}")
    for name, o in out.items():
        print(f"[examples] on {card}: {name} exit 0: {o['tail'][-1]}",
              flush=True)
    print(f"[examples] ({secs:.1f}s, beside [checks])", flush=True)
    return {"examples": out, "examples_s": secs}


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


def phase_timing(rec, launches, err, card: str, remote=None) -> tuple:
    """Each kernel at every shape key S the main paths gave it, on the
    arguments it was given there: held against its plain version once
    more (exactly; flash attention within its tolerance), then timed: the
    kernel by its device time (``_device_ms``, median of 21 launches),
    the plain version on the same arguments by events around the call
    (one call after the check's; its host launch time included, as its
    users pay it;
    flash attention's one batch row after the other, since it holds
    H * S^2 f32 scores per row) and, for flash attention, the SDPA
    yardstick on the same arguments (``_flash_yardstick``). A kernel's
    ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are means over
    the paths' launches (each S weighted by its launch count), so each
    pair is held on the same inputs. ``remote``: the launches made in
    replica processes, counted in ``launches`` but not recorded (their
    inputs stay in those processes), so the means are over this
    process's launches."""
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
        here = launches[name] - (remote or {}).get(name, 0)
        if sum(weights.values()) != here:
            raise AssertionError(f"{name}: {sum(weights.values())} calls"
                                 f" recorded, {here} launches in this "
                                 f"process")
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
                   # the check's call above is the plain version's warm-up
                   "plain_ms": _median_ms(lambda: plain(*a, **kw), n=1,
                                          warm=0),
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
            print(f"[timing] {name} at (B, S, window, D) = {r['S']} x"
                  f"{r['launches']}: {r['ms']:.3f} ms (bound "
                  f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.3f}{old}; at "
                  f"softcap 0 the kernel {r['kernel_softcap0_ms']:.3f} vs "
                  f"SDPA {r['library_ms']:.3f})", flush=True)
    rows = {r["S"]: r for r in per_shape["flash_attention_tc"]}
    for argv, D in ((LM_ARGV, 256), (MOE_ARGV, 128)):
        S = _prompt_len(argv)
        if (4, S, 0, D) not in rows:
            raise AssertionError(f"no tensor-core launch at the prefill's "
                                 f"B=4 S={S} D={D}")
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
    lm["checks"] = phase_lm_checks(dev, cfg, params, rec,
                                   _prompt_len(LM_ARGV), profile=True)
    lm["checks_s"] = time.perf_counter() - t0
    checks_lm = {k: v for k, v in lm["checks"].items()
                 if not k.startswith("profile")}
    print(f"[lm-checks] {checks_lm} ({lm['checks_s']:.1f}s)", flush=True)
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

    # the MoE LM at full width, alone on the card too (gemma2's 36.97 GB
    # and its 55.4 GB do not fit together); freed before the retrieval
    t0 = time.perf_counter()
    moe, moe_launches, cfg, params = phase_lm(
        dev, card, rec, MOE_ARGV, MOE_SCHED_PROMPTS, "moe")
    moe["moe_s"] = time.perf_counter() - t0
    print(f"[moe] ({moe['moe_s']:.1f}s)", flush=True)
    t0 = time.perf_counter()
    moe["checks"] = phase_lm_checks(dev, cfg, params, rec,
                                    _prompt_len(MOE_ARGV), MOE_SMOKE_ARCHS)
    moe["checks_s"] = time.perf_counter() - t0
    print(f"[moe-checks] {moe['checks']} ({moe['checks_s']:.1f}s)",
          flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # LM training at stablelm-12b's published widths, alone on the card
    # too: its kernels are none (the JAX training step attends outside
    # its forward-only flash kernel), so none may launch
    import dataclasses
    from repro_torch.configs.registry import get_arch
    t0 = time.perf_counter()
    _build.reset_launches()
    train = phase_train(dev, card, dataclasses.replace(
        get_arch(TRAIN_ARCH).config, n_layers=TRAIN_LAYERS))
    if any(_build.LAUNCHES.values()):
        raise AssertionError(f"[train] launched a kernel: "
                             f"{dict(_build.LAUNCHES)}")
    train["train_s"] = time.perf_counter() - t0
    print(f"[train] ({train['train_s']:.1f}s)", flush=True)
    t0 = time.perf_counter()
    import shutil
    tmp = ROOT / "build" / f"chip_smoke_train_{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        train["checks"] = phase_train_checks(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    train["checks_s"] = time.perf_counter() - t0
    print(f"[train-checks] {train['checks']} ({train['checks_s']:.1f}s)",
          flush=True)
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
    # [examples] runs beside [checks]: neither is timed as a metric
    started = start_examples()
    try:
        checks = phase_checks(phases, dev, batch0)
    finally:
        examples = finish_examples(started, card)
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
    durable, d_launches, made = phase_durable(args, dev, card, rec,
                                              del_ids, upd_ids)
    durable["durable_s"] = time.perf_counter() - t0
    print(f"[durable] ({durable['durable_s']:.1f}s)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    envelope, e_launches = phase_envelope(args, dev, card, rec, made)
    envelope["envelope_s"] = time.perf_counter() - t0
    print(f"[envelope] ({envelope['envelope_s']:.1f}s)", flush=True)
    gc.collect()
    t0 = time.perf_counter()
    steady, s_launches = phase_steady(args, dev, card, rec, made)
    steady["steady_s"] = time.perf_counter() - t0
    print(f"[steady] ({steady['steady_s']:.1f}s)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fleet, f_launches = phase_fleet(args, dev, card, rec, made)
    del made
    fleet["fleet_s"] = time.perf_counter() - t0
    print(f"[fleet] ({fleet['fleet_s']:.1f}s)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh, m_launches = phase_mesh(dev, card, rec)
    mesh["mesh_s"] = time.perf_counter() - t0
    print(f"[mesh] ({mesh['mesh_s']:.1f}s)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    launches = {n: launches[n] + d_launches[n] + lm_launches[n]
                + lm["checks"]["f32_launches"][n] + moe_launches[n]
                + moe["checks"]["f32_launches"][n] + e_launches[n]
                + s_launches[n] + f_launches[n] + m_launches[n]
                for n in launches}

    t0 = time.perf_counter()
    children = list(fleet["launches_children"].values()) \
        + list(mesh["launches_children"].values())
    remote = {n: sum(c[n] for c in children) for n in launches}
    line, per_shape = phase_timing(rec, launches, err, card, remote)
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
        "durable": durable, "lm": lm, "moe": moe, "train": train,
        "envelope": envelope,
        "steady": steady, "fleet": fleet, "mesh": mesh,
        "examples": examples,
        "kernels": line, "kernel_shapes": per_shape,
        "total_s": time.perf_counter() - t_start}, indent=1, default=str))
    total_s = time.perf_counter() - t_start
    print(f"[total] total_s {total_s:.1f}; the durable path "
          f"{durable['durable_s']:.1f}s, ratio "
          f"{total_s / durable['durable_s']:.3f}", flush=True)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
