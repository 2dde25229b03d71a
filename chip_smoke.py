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
              128 query rows;
4. slice    — the main path through ``repro_torch.launch.serve`` with the
              full ``lucene_envelope`` CONFIG over a corpus with
              ClueWeb09b's law scaled to ``--docs``: index, refresh, serve
              ``--requests`` queries (32 slots, 4 terms, k=10), index
              more, refresh, serve, delete 8 + update 4 docs, refresh,
              serve. Kernel launch counts are zeroed just before and read
              just after; every kernel of the path must have launched;
5. checks   — pruned == exhaustive bit for bit on the first 32 queries on
              the card, in the tombstone-free and the tombstoned snapshot,
              every pruned id carrying its true score (ids may differ only
              among equal scores); the card's top-k equal the port's CPU
              path on a 2^14-doc index built from the same batch;
6. profile  — where serving time goes: device busy share of 4 served
              batches under ``torch.profiler`` (device-side events only),
              top kernels, and the host functions with the most own time
              under ``cProfile``;
7. timing   — each kernel on the very inputs the slice gave it, at every
              leading size (blocks) it was launched with: held exactly
              against its plain version once more, then its median time
              over 21 launches, its plain version's time and its bound
              (the bytes its data needs at 3.35 TB/s vs its f32 operations
              at 67 TFLOP/s, the H100 SXM peaks at a 700 W limit; integer
              bit operations are not counted — the table of peaks has no
              rate for them), each averaged over the path's launches.

Prints the kernels as one JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Details (ptxas report, every timing,
the profiles) go to ``<--out>/chip_smoke.json``, ``build/chip_smoke/`` by
default. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import cProfile
import json
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
    torch.cuda.synchronize()
    return err


def phase_slice(args, dev):
    """The main path; returns its snapshots, report, launch counts and
    the inputs each kernel was given (``ShapeRecorder``)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    argv = ["--device", str(dev), "--config", "full", "--docs",
            str(args.docs), "--batch-docs", str(args.batch_docs),
            "--requests", str(args.requests), "--slots", "32",
            "--query-terms", "4", "--topk", "10", "--deletes", "8",
            "--updates", "4"]
    with ShapeRecorder() as rec:
        _build.reset_launches()
        phases, report = serve.main(argv)
        launches = dict(_build.LAUNCHES)
    for name in ("pack", "bm25_blocks", "bm25_blocks_midgrid"):
        if launches[name] <= 0:
            raise AssertionError(f"the main path never launched {name}: "
                                 f"{launches}")
    return phases, report, launches, rec


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


class ShapeRecorder:
    """Wraps the kernel ops the main path calls, for the slice only: counts
    each op's calls by their leading size S (blocks) and keeps a copy of
    the first call's arguments at each S, so ``phase_timing`` can time
    every kernel on the inputs the path gave it. The launch counts stay
    the wrappers' own."""

    def __init__(self):
        import collections
        from repro_torch.core import query
        from repro_torch.kernels.postings_pack import ops as pops
        self.counts = collections.defaultdict(collections.Counter)
        self.args: dict = collections.defaultdict(dict)
        # (module, attribute, kernel name): where the path looks each op up
        self._sites = [(pops, "pack", "pack"),
                       (query, "bm25_blocks", "bm25_blocks"),
                       (query, "bm25_blocks_midgrid", "bm25_blocks_midgrid")]
        self._orig = [getattr(m, a) for m, a, _ in self._sites]

    def _wrap(self, fn, name):
        import torch

        def recorded(*args, **kwargs):
            S = int(args[0].shape[0])
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


def _plane_bytes(bw_docs, bw_tf, keep) -> int:
    """Bytes of the bit planes a block needs: bw planes of 4 words each,
    for the kept blocks only."""
    return int(((bw_docs + bw_tf) * keep).sum()) * 16


def _work(name, args, kwargs, out):
    """(bytes moved, f32 operations) that this call's data needs: each
    input read once (planes only up to each block's bit width, and only
    for blocks the kernel scores), each output written once."""
    import torch
    S = int(args[0].shape[0])
    if name in ("pack", "unpack"):
        return S * 128 * 4 + S * (512 + 4), 0
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
    then timed (median of 21 launches; the plain version median of 3).
    A kernel's ``ms``, ``plain_ms`` and ``bound_ms`` are means over the
    path's launches (each S weighted by its launch count). unpack is not
    on the path: it runs at pack's shapes, on pack's outputs."""
    from repro_torch.kernels.bm25_blockmax import ops as bops
    from repro_torch.kernels.bm25_blockmax import ref as bref
    from repro_torch.kernels.postings_pack import ops as pops
    from repro_torch.kernels.postings_pack import ref as pref
    calls = {"pack": (pops.pack, pref.pack_ref),
             "unpack": (pops.unpack, pref.unpack_ref),
             "bm25_blocks": (bops.bm25_blocks,
                             lambda *a, k1, b: bref.bm25_blocks_ref(*a, k1)),
             "bm25_blocks_midgrid": (bops.bm25_blocks_midgrid,
                                     bref.bm25_blocks_midgrid_ref)}
    sources = {"pack": ("postings_pack.cu", "postings_pack/kernel.py:56"),
               "unpack": ("postings_pack.cu", "postings_pack/kernel.py:80"),
               "bm25_blocks": ("bm25_blockmax.cu",
                               "bm25_blockmax/kernel.py:250"),
               "bm25_blocks_midgrid": ("bm25_blockmax.cu",
                                       "bm25_blockmax/kernel.py:294")}
    line, per_shape = [], {}
    for name, (kern, plain) in calls.items():
        rec_name = "pack" if name == "unpack" else name
        weights = rec.counts[rec_name]
        if sum(weights.values()) != launches[rec_name]:
            raise AssertionError(f"{rec_name}: {sum(weights.values())} calls"
                                 f" recorded, {launches[rec_name]} launches")
        rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        by = {"bytes": 0.0, "operations": 0.0}
        for S in sorted(weights):
            a, kw = rec.args[rec_name][S]
            if name == "unpack":
                a, kw = tuple(pops.pack(a[0])), {}
            out = kern(*a, **kw)
            out = list(out) if isinstance(out, (tuple, list)) else [out]
            want = plain(*a, **kw)
            want = list(want) if isinstance(want, (tuple, list)) else [want]
            err[name] = max(err[name], _exact(f"{name} at S={S}", out, want))
            nbytes, f32_ops = _work(name, a, kw, out)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = f32_ops / F32_OPS_PER_S * 1e3
            row = {"S": S, "launches": weights[S],
                   "ms": _median_ms(lambda: kern(*a, **kw)),
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
