#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                     # the full run (2^20 docs)
    python3 chip_smoke.py --docs 65536        # a shorter run

Phases, in order; any failure exits non-zero and prints no ``ok`` line:

1. device   — the card's ``name, power.limit`` (nvidia-smi);
2. build    — compile the hand-written kernels from ``src/repro_torch/
              kernels/csrc`` (one nvcc per source, in parallel);
3. parity   — each kernel against its plain PyTorch version on the card,
              exactly: pack/unpack on random words with bw 0 and 32 edge
              blocks, bm25_blocks with and without partials, midgrid at
              every pow2 bucket up to 4096 blocks for k in {1, 10, 32} and
              128 query rows, bm25_blocks_compact at S in {1, 37, 4099}
              with bw-0/bw-32 blocks and the rows array's last block;
4. slice    — the main path through ``repro_torch.launch.serve`` with the
              full ``lucene_envelope`` CONFIG over a corpus with
              ClueWeb09b's law scaled to half of ``--docs``: index,
              refresh, serve ``--requests`` queries (32 slots, 4 terms,
              k=10), index more, refresh, serve, delete 8 + update 4
              docs, refresh, serve. Kernel launch counts are zeroed just
              before and read just after; every kernel of the path must
              have launched;
5. checks   — pruned == exhaustive bit for bit on the first 32 queries on
              the card, in the tombstone-free and the tombstoned snapshot,
              every pruned id carrying its true score (ids may differ only
              among equal scores); the card's top-k equal the port's CPU
              path on a 2^14-doc index built from the same batch;
6. profile  — where serving time goes: device busy share of 4 served
              batches under ``torch.profiler`` (device-side events only),
              top kernels, and the host functions with the most own time
              under ``cProfile``;
7. durable  — the durable path at the same width and depth: index every
              batch into an ``FSDirectory`` on the local disk with the
              WAL, apply the slice's 8 deletes + 4 updates, ``commit()``;
              recover with ``open_searcher(..., ReaderCache(compact=
              True))`` and serve ``--requests`` queries through the
              compact layout; hold every batch against a dense-layout
              searcher over the same recovered segments and pruned
              against exhaustive; then index one more batch with the WAL
              and no commit, drop that indexer, reopen the directory and
              check that the WAL replays the acked docs and a query batch
              returns what it returned before the drop. Launch counts are
              zeroed before and read after the indexing + recovery +
              serving run and the WAL run (not around the comparisons);
8. timing   — each kernel on the very inputs the paths gave it, at every
              leading size (blocks) it was launched with: held exactly
              against its plain version once more, then its median device
              time over 21 launches queued behind a spin kernel (the
              host's launch time hidden; L2 flushed before each), its
              plain version's time with the host's launch time included,
              and its bound (the bytes its data needs at 3.35 TB/s vs its
              f32 operations at 67 TFLOP/s, the H100 SXM peaks at a 700 W
              limit; integer bit operations are not counted — the table
              of peaks has no rate for them), each averaged over the
              path's launches.

The durable path runs at ``--docs`` (2^20 by default) and the in-memory
slice at half of it: at 2^20 docs each, the two paths took 726.7-864.8 s
together and the script 835.3-1002.9 s of its 1200 s limit on an NVIDIA
H100 80GB HBM3 at a 700.00 W power limit, and only the earlier path's
depth may be cut.

Prints the kernels as one JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Details (ptxas report, every timing,
the profiles) go to ``<--out>/chip_smoke.json``, ``build/chip_smoke/`` by
default. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def phase_parity(dev) -> dict:
    """Every kernel vs its plain version on the card, exactly."""
    import numpy as np
    import torch
    from repro_torch.kernels.bm25_blockmax import ops as bops
    from repro_torch.kernels.bm25_blockmax import ref as bref
    from repro_torch.kernels.postings_pack import ops as pops
    from repro_torch.kernels.postings_pack import ref as pref
    rng = np.random.default_rng(0)
    err = {}
    words = rng.integers(0, 2 ** 32, (4096, 128), dtype=np.uint64)
    words >>= rng.integers(0, 33, (4096, 1)).astype(np.uint64)
    words = words.astype(np.uint32)
    words[0], words[1], words[2] = 0, 0xFFFFFFFF, 1   # bw 0, 32, 1
    d = torch.from_numpy(words.view(np.int32)).to(dev)
    got, want = pops.pack(d), pref.pack_ref(d)
    err["pack"] = _exact("pack", got, want)
    bw = got[1].cpu()
    assert int(bw[0]) == 0 and int(bw[1]) == 32, bw[:3]
    back = pops.unpack(*got)
    err["unpack"] = _exact("unpack", [back], [pref.unpack_ref(*want)])
    assert torch.equal(back, d), "unpack(pack(x)) != x"

    e = 0.0
    for S in (1, 37, 4096):
        args = _blocks(rng, S, dev, pref)
        e = max(e, _exact("bm25_blocks", bops.bm25_blocks(*args),
                          bref.bm25_blocks_ref(*args)))
        e = max(e, _exact("bm25_blocks partials",
                          bops.bm25_blocks_partials(*args),
                          bref.bm25_blocks_partials_ref(*args)))
    err["bm25_blocks"] = e

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
    for S in (1, 37, 4099):
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
    torch.cuda.synchronize()
    return err


def phase_slice(args, dev):
    """The main path; returns its snapshots, report, launch counts and
    the inputs each kernel was given (``ShapeRecorder``)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    argv = ["--device", str(dev), "--config", "full", "--docs",
            str(args.docs // 2), "--batch-docs", str(args.batch_docs),
            "--requests", str(args.requests), "--slots", "32",
            "--query-terms", "4", "--topk", "10", "--deletes", "8",
            "--updates", "4"]
    rec = ShapeRecorder()
    with rec:
        _build.reset_launches()
        phases, report = serve.main(argv)
        launches = dict(_build.LAUNCHES)
    _require(launches, ("pack", "bm25_blocks", "bm25_blocks_midgrid"),
             "the in-memory slice")
    return phases, report, launches, rec


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


def _leading(name: str, args) -> int:
    """A kernel call's leading size S: blocks (the compact op's first
    argument is the whole rows array; its blocks are its offsets)."""
    return int(args[1 if name == "bm25_blocks_compact" else 0].shape[0])


class ShapeRecorder:
    """Wraps the kernel ops the main paths call, only while a path runs
    (``with rec:``, once per counted run): counts each op's calls by their
    leading size S (blocks) and keeps a copy of the first call's
    arguments at each S, so ``phase_timing`` can time every kernel on the
    inputs the paths gave it. The launch counts stay the wrappers' own."""

    def __init__(self):
        import collections
        from repro_torch.core import query
        from repro_torch.kernels.postings_pack import ops as pops
        self.counts = collections.defaultdict(collections.Counter)
        self.args: dict = collections.defaultdict(dict)
        # (module, attribute, kernel name): where the paths look each op
        # up (the storage codec and the reader build call pops.pack)
        self._sites = [(pops, "pack", "pack"), (pops, "unpack", "unpack"),
                       (query, "bm25_blocks", "bm25_blocks"),
                       (query, "bm25_blocks_midgrid", "bm25_blocks_midgrid"),
                       (query, "bm25_blocks_compact", "bm25_blocks_compact")]
        self._orig = [getattr(m, a) for m, a, _ in self._sites]

    def _wrap(self, fn, name):
        import torch

        def recorded(*args, **kwargs):
            S = _leading(name, args)
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


def _work(name, args, kwargs, out):
    """(bytes moved, f32 operations) that this call's data needs: each
    input read once (planes only up to each block's bit width, and only
    for blocks the kernel scores), each output written once."""
    import torch
    S = _leading(name, args)
    if name == "pack":
        return S * 128 * 4 + S * (512 + 4), 0
    if name == "unpack":
        # the live planes (16 B each) and bw in; the (S, 128) words out
        return int(args[1].to(torch.int64).sum()) * 16 + S * 4 + S * 512, 0
    if name == "bm25_blocks_compact":
        # coff/bw/first x2 less one first, idf, active; the live plane
        # rows (16 B each) of the scored blocks; three (S, 128) outputs
        keep = args[8].to(torch.int64)
        nbytes = S * 7 * 4 + _plane_bytes(args[2], args[6], keep) \
            + S * 128 * 12
        return nbytes, int(keep.sum()) * 128 * 2
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
    return nbytes, int(keep.sum()) * 128 * ops_per_lane


def phase_timing(rec, launches, err) -> tuple:
    """Each kernel at every leading size S the main path gave it, on the
    arguments it was given there: held exactly against its plain version,
    then timed: the kernel by its device time (``_device_ms``, median of
    21 launches), the plain version by events around the call (median of
    3; its host launch time included, as its users pay it).
    A kernel's ``ms``, ``plain_ms`` and ``bound_ms`` are means over the
    paths' launches (each S weighted by its launch count)."""
    from repro_torch.kernels.bm25_blockmax import ops as bops
    from repro_torch.kernels.bm25_blockmax import ref as bref
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
                 lambda *a, k1: bref.bm25_blocks_compact_ref(*a, k1))}
    sources = {"pack": ("postings_pack.cu", "postings_pack/kernel.py:56"),
               "unpack": ("postings_pack.cu", "postings_pack/kernel.py:80"),
               "bm25_blocks": ("bm25_blockmax.cu",
                               "bm25_blockmax/kernel.py:250"),
               "bm25_blocks_midgrid": ("bm25_blockmax.cu",
                                       "bm25_blockmax/kernel.py:294"),
               "bm25_blocks_compact": ("bm25_blockmax.cu",
                                       "bm25_blockmax/kernel.py:210")}
    line, per_shape = [], {}
    for name, (kern, plain) in calls.items():
        weights = rec.counts[name]
        if sum(weights.values()) != launches[name]:
            raise AssertionError(f"{name}: {sum(weights.values())} calls"
                                 f" recorded, {launches[name]} launches")
        rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        by = {"bytes": 0.0, "operations": 0.0}
        for S in sorted(weights):
            a, kw = rec.args[name][S]
            out = kern(*a, **kw)
            out = list(out) if isinstance(out, (tuple, list)) else [out]
            want = plain(*a, **kw)
            want = list(want) if isinstance(want, (tuple, list)) else [want]
            err[name] = max(err[name], _exact(f"{name} at S={S}", out, want))
            nbytes, f32_ops = _work(name, a, kw, out)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = f32_ops / F32_OPS_PER_S * 1e3
            row = {"S": S, "launches": weights[S],
                   "ms": _device_ms(lambda: kern(*a, **kw)),
                   "plain_ms": _median_ms(lambda: plain(*a, **kw), n=3,
                                          warm=1),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
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
            "bound_by": max(by, key=by.get), "library_ms": None})
        common = max(rows, key=lambda r: (r["launches"], r["S"]))
        print(f"[timing] {name}: {line[-1]['ms']:.4f} ms per launch on the "
              f"path (plain {line[-1]['plain_ms']:.3f} ms, bound "
              f"{line[-1]['bound_ms']:.5f} ms); most frequent S={common['S']}"
              f" x{common['launches']}: {common['ms']:.4f} ms; largest "
              f"S={rows[-1]['S']} x{rows[-1]['launches']}: "
              f"{rows[-1]['ms']:.4f} ms", flush=True)
    return line, per_shape


def phase_profile(phases, dev, k: int = 10) -> dict:
    """Where serving time goes: 4 batches of 32 queries on the full
    tombstone-free snapshot, timed plain, then again under
    ``torch.profiler``. Device busy share = summed kernel time / the
    unprofiled wall time of the same batches."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    searcher = phases["refreshed"][0]
    reqs = phases["first"][1]
    q = np.stack([r.terms for r in reqs[:128]]).astype(np.int32)
    batches = [q[i:i + 32] for i in range(0, len(q), 32)]

    def serve():
        for b in batches:
            searcher.search_batched(b, k)
        torch.cuda.synchronize()

    serve()
    t0 = time.perf_counter()
    serve()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve()
    # device-side events only (kernels, memcpys, memsets): an ATen op's
    # device time is that of the kernels it launched, counted there already
    kernels = []
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and dt > 0:
            kernels.append((dt / 1e3, e.key, e.count))
    kernels.sort(reverse=True)
    dev_ms = sum(t for t, _, _ in kernels)
    # the host side of the same batches: the functions with the most own
    # time (cProfile inflates Python-heavy code; read it as an ordering)
    prof_host = cProfile.Profile()
    prof_host.runcall(serve)
    st = pstats.Stats(prof_host)
    host = sorted(((v[2] * 1e3, v[3] * 1e3,
                    f"{Path(f[0]).name}:{f[1]}:{f[2]}")
                   for f, v in st.stats.items()), reverse=True)
    return {"batches": len(batches), "wall_ms": wall_ms,
            "device_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms if dev_ms else None,
            "top_device_ops": [{"ms": t, "op": n[:80], "count": c}
                               for t, n, c in kernels[:12]],
            "top_host_self_ms": [{"self_ms": t, "cum_ms": c, "fn": n}
                                 for t, c, n in host[:15]]}


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

    t0 = time.perf_counter()
    err = phase_parity(dev)
    print(f"[parity] every kernel equals its plain version exactly "
          f"({time.perf_counter() - t0:.1f}s): {err}", flush=True)

    t0 = time.perf_counter()
    phases, report, launches, rec = phase_slice(args, dev)
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
    launches = {n: launches[n] + d_launches[n] for n in launches}

    t0 = time.perf_counter()
    line, per_shape = phase_timing(rec, launches, err)
    print(f"[timing] ({time.perf_counter() - t0:.1f}s)", flush=True)

    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "ptxas": {k: v[1] for k, v in
                                      _build.BUILD_LOG.items()},
        "report": report, "checks": checks, "profile": prof,
        "durable": durable,
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
