"""``chip_smoke.py``'s ``[build]`` gates on the redesigned kernels, read
from ``ptxas -v`` reports shaped as the card's compiler writes them: the
retrieval gate passes when pack, unpack, bm25_blocks (both
instantiations), compact and the four midgrid walk instantiations are
there without spills, and fails when one is missing or spills
(``unpack_kernel`` must not stand in for ``pack_kernel``); the SIMT flash
gate fails when a D = 256 instantiation (f32 or bf16) spills or is
missing. The pure helpers of the ``[envelope]``, ``[steady]`` and
``[fleet]`` phases (the fixed arrival rate and the uncached probe beside
it, each gate's comparisons, the deleted-doc and result-cache checks,
the live segments' file bytes, the fleet's deletes) pass on sound inputs
and fail on a planted fault each; launch counting and ``ShapeRecorder``
count exactly from 8 threads at once; the ``[fleet]`` phase runs whole
on the CPU with two replica processes."""
import dataclasses
import importlib.util
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PACK = "_ZN48_GLOBAL__N__4c14c7ce_16_postings_pack_cu_pp_pack"
BM25 = "_ZN49_GLOBAL__N__82b79dd6_16_bm25_blockmax_cu_207e091d"
KERNELS = {
    "postings_pack": [PACK + "13unpack_kernelEPK5uint4PKiPjx",
                      PACK + "11pack_kernelEPKjP5uint4Pix"],
    "bm25_blockmax": [BM25 + f"19midgrid_walk_kernelILi{n}EEEvPKiS2_PKfS4_S4_"
                             "iiPix" for n in (4, 3, 2, 1)]
    + [BM25 + "21midgrid_decode_kernelEPKjPKiS3_S1_S3_PKfS3_S5_fiPiPfS7_S7_",
       BM25 + "19bm25_compact_kernelEPK5uint4xPKiS4_S4_S2_xS4_S4_PKfS4_fPiPf"
              "S8_x",
    ] + [BM25 + f"11bm25_kernelILb{p}EEvPK5uint4PKiS5_S3_S5_PKfS5_ffPiPfS9_"
               "S8_x" for p in (0, 1)],
}
FLASH = ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c13897916flash_"
         "fwd_kernelI{t}Li{n}EEEv14CUtensorMap_stS3_S3_PKT_S6_S6_PS4_Piiiiii"
         "iiiff")
SIMT = [FLASH.format(t=t, n=n) for t in ("f", "13__nv_bfloat16")
        for n in (2, 1)]


def _report(fns, spill: str = "", drop: str = "") -> str:
    lines = ["ptxas info    : 0 bytes gmem"]
    for fn in fns:
        if drop and drop in fn:
            continue
        n = 8 if spill and spill in fn else 0
        lines += [f"ptxas info    : Compiling entry function '{fn}' for "
                  f"'sm_90a'",
                  f"ptxas info    : Function properties for {fn}",
                  f"    0 bytes stack frame, {n} bytes spill stores, {n} "
                  f"bytes spill loads",
                  "ptxas info    : Used 32 registers, used 0 barriers"]
    return "\n".join(lines)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_gate_passes_without_spills(chip_smoke, monkeypatch):
    monkeypatch.setattr(_build, "build_report",
                        lambda name: _report(KERNELS[name]))
    got = chip_smoke.retrieval_build_check()
    assert set(got) == {"pack_kernel", "unpack_kernel", "bm25_compact_kernel",
                        "bm25_kernel<0>", "bm25_kernel<1>",
                        *(f"midgrid_walk_kernel<{n}>" for n in range(1, 5))}
    assert all(p == {"spill_bytes": 0, "registers": 32}
               for p in got.values())


@pytest.mark.parametrize("kernel", ["13unpack_kernel", "11pack_kernel",
                                    "19bm25_compact_kernel", "ILi3E",
                                    "ILb0E", "ILb1E"])
@pytest.mark.parametrize("fault", ["spill", "drop"])
def test_build_gate_fails_on_a_spill_or_a_missing_kernel(chip_smoke,
                                                         monkeypatch, kernel,
                                                         fault):
    monkeypatch.setattr(_build, "build_report", lambda name: _report(
        KERNELS[name], **{fault: kernel}))
    with pytest.raises(AssertionError, match="missing from the ptxas report "
                                             "or spills"):
        chip_smoke.retrieval_build_check()


def test_simt_flash_gate_passes_without_spills(chip_smoke, monkeypatch):
    monkeypatch.setattr(_build, "build_report", lambda name: _report(SIMT))
    got = chip_smoke.simt_build_check()
    assert set(got) == {"f32_NC1", "f32_NC2", "bf16_NC1", "bf16_NC2"}


@pytest.mark.parametrize("kernel", ["IfLi2E", "I13__nv_bfloat16Li2E"])
@pytest.mark.parametrize("fault", ["spill", "drop"])
def test_simt_flash_gate_fails_on_a_d256_spill_or_a_missing_kernel(
        chip_smoke, monkeypatch, kernel, fault):
    monkeypatch.setattr(_build, "build_report", lambda name: _report(
        SIMT, **{fault: kernel}))
    with pytest.raises(AssertionError, match="missing or spills"):
        chip_smoke.simt_build_check()


def _threads(fn, n: int = 8, calls: int = 2000):
    """``fn`` called ``calls`` times from each of ``n`` threads released
    together, switching threads as often as the interpreter allows."""
    barrier = threading.Barrier(n)

    def run():
        barrier.wait()
        for _ in range(calls):
            fn()
    ts = [threading.Thread(target=run) for _ in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    return n * calls


class _YieldingDict(dict):
    """A dict whose reads give up the GIL: a read-modify-write of one of
    its items that holds no lock loses updates between threads."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counts_are_exact_from_8_threads(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", _YieldingDict(_build.LAUNCHES))
    _build.reset_launches()
    n = _threads(lambda: _build.count_launch("pack"), calls=1000)
    assert _build.LAUNCHES["pack"] == n
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values())


def test_shape_recorder_counts_exactly_from_8_threads(chip_smoke):
    from repro_torch.kernels.postings_pack import ops as pops
    rec = chip_smoke.ShapeRecorder()
    words = [torch.randint(0, 1 << 20, (nb, 128), dtype=torch.int32)
             for nb in (1, 3, 5, 7)]
    i = iter(range(10 ** 9))
    with rec:
        n = _threads(lambda: pops.pack(words[next(i) % 4]), calls=200)
    assert sum(rec.counts["pack"].values()) == n
    assert dict(rec.counts["pack"]) == {1: n // 4, 3: n // 4, 5: n // 4,
                                        7: n // 4}
    assert set(rec.args["pack"]) == {1, 3, 5, 7}
    assert pops.pack is rec._orig[0]


def test_steady_qps_is_the_jax_serve_steady_rate(chip_smoke):
    """[steady] is offered the fixed rate of the JAX serve_steady bench
    (benchmarks/run.py:1087), whatever [slice] or the probe measured."""
    assert chip_smoke.STEADY_QPS == 75.0


def test_probe_qps_fails_when_the_probe_served_no_query(chip_smoke):
    """Pool queries with no terms leave every probe lane padding: no query
    was served, so no QPS was measured, and the probe fails."""
    idle = types.SimpleNamespace(search_batched=lambda q, k: None)
    with pytest.raises(AssertionError, match="QPS"):
        chip_smoke.probe_qps(idle, [np.zeros(0, np.int32)], 32, 4, 10)


def test_probe_qps_runs_warm_searchers_probe_uncached(chip_smoke):
    """The probe is ``warm_searcher``'s batches once more: at 32 slots,
    120 queries in 21 batches (every pow2 occupancy of every pow2
    bucket), timed on the host clock."""
    from repro_torch.configs.lucene_envelope import SMOKE
    from repro_torch.core.indexer import Indexer
    from repro_torch.data.corpus import TINY, SyntheticCorpus
    corpus = SyntheticCorpus(TINY, doc_buffer_len=SMOKE.doc_len)
    ix = Indexer(cfg=SMOKE, device="cpu")
    ix.index_batch(corpus.batch(0, 32))
    searcher = ix.refresh()
    vocab = np.unique(corpus.batch(0, 32))[1:]
    pool = [vocab[i:i + 4].astype(np.int32) for i in range(0, 64, 4)]
    out = chip_smoke.probe_qps(searcher, pool, 32, 4, 10)
    assert out["queries"] == 120
    assert out["s"] > 0 and out["qps"] == out["queries"] / out["s"]


def test_fleet_deletes_pick_the_docs_holding_the_query_terms(chip_smoke):
    tokens = np.zeros((12, 6), np.int32)
    tokens[3, :3] = [7, 8, 9]       # 3 query terms
    tokens[5, :2] = [7, 7]          # 2
    tokens[1, 0] = 9                # 1
    tokens[8, 0] = 8                # 1
    q = np.array([[7, 8], [9, 11]], np.int32)
    got = chip_smoke.fleet_deletes(tokens, q, 1000, 4)
    assert got.tolist() == [1001, 1003, 1005, 1008]
    assert got.dtype == np.int64


def _fleet_inputs():
    here = {"pack": 40, "unpack": 6, "bm25_blocks": 3,
            "bm25_blocks_midgrid": 30}
    children = {"s1r0": {"pack": 4, "unpack": 3, "bm25_blocks": 0,
                         "bm25_blocks_midgrid": 12},
                "s1r1": {"pack": 4, "unpack": 3, "bm25_blocks": 2,
                         "bm25_blocks_midgrid": 0}}
    return here, children, 0, 2, 0


def test_fleet_gates_pass(chip_smoke):
    chip_smoke.fleet_gates(*_fleet_inputs())


@pytest.mark.parametrize("fault", [
    "unpack here", "scoring here", "pack here", "unpack s1r0",
    "scoring s1r1", "shed", "failovers", "degraded"])
def test_fleet_gates_fail_on_a_planted_fault(chip_smoke, fault):
    here, children, shed, failovers, degraded = _fleet_inputs()
    if fault == "unpack here":
        here["unpack"] = 0
    elif fault == "scoring here":
        here["bm25_blocks"] = here["bm25_blocks_midgrid"] = 0
    elif fault == "pack here":
        here["pack"] = 0
    elif fault == "unpack s1r0":
        children["s1r0"]["unpack"] = 0
    elif fault == "scoring s1r1":
        children["s1r1"]["bm25_blocks"] = 0
    elif fault == "shed":
        shed = 1
    elif fault == "failovers":
        failovers = 0
    else:
        degraded = 1
    with pytest.raises(AssertionError, match=r"\[fleet\] gates"):
        chip_smoke.fleet_gates(here, children, shed, failovers, degraded)


def test_phase_fleet_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """The whole [fleet] phase on the CPU at 64 docs a batch, with two
    replica processes on the CPU: its syncs, serving, failover and heals
    run, and every served batch passes the union-oracle checks. No kernel
    launches on the CPU, so the launch gates get what the run counted
    instead of being applied."""
    from types import SimpleNamespace
    gated = []
    monkeypatch.setattr(chip_smoke, "fleet_gates",
                        lambda *a: gated.append(a))
    args = SimpleNamespace(batch_docs=64)
    rep, launches = chip_smoke.phase_fleet(
        args, torch.device("cpu"), "cpu", chip_smoke.ShapeRecorder())
    assert len(gated) == 1
    here, children, shed, failovers, degraded = gated[0]
    assert set(children) == {"s1r0", "s1r1"}
    assert shed == 0 and failovers >= 1 and degraded == 0
    assert not any(launches.values())
    assert rep["checked_batches"] == (
        chip_smoke.FLEET_SERVE_BATCHES + chip_smoke.FLEET_DEGRADED_BATCHES
        + 2 * chip_smoke.FLEET_HEALED_BATCHES)
    assert sorted(rep["syncs"]) == ["s0r0", "s0r1", "s1r0", "s1r1"]
    assert all(set(s) == {"first", "delta"} and s["first"]["files"] > 0
               for s in rep["syncs"].values())
    assert len(rep["deleted"]) == 2 * chip_smoke.FLEET_DELETES
    assert rep["oracle_docs"] == 2 * (5 * 64 - chip_smoke.FLEET_DELETES)
    assert rep["repair"]["files"] >= 1 and rep["anti_entropy"]["repaired"]
    assert all(l["replicas_current"] == 2 for l in rep["ledgers"])
    assert not list((chip_smoke.ROOT / "build").glob("chip_smoke_fleet_*"))


PAIRS = (("nas", "ssd"), ("ssd", "ssd"))


def _envelope_inputs():
    reps = {("nas", "ssd"): {"bytes_read_measured": 1000,
                             "index_bytes_encoded": 400,
                             "gb_per_min_measured": 3.0},
            ("ssd", "ssd"): {"bytes_read_measured": 1000,
                             "index_bytes_encoded": 400,
                             "gb_per_min_measured": 2.0}}
    return reps, {p: 1000 for p in PAIRS}, {p: 400 for p in PAIRS}


def test_envelope_gates_pass(chip_smoke):
    assert chip_smoke.envelope_gates(*_envelope_inputs()) == 1.5


@pytest.mark.parametrize("fault,match", [
    ("bytes_read", "bytes_read_measured"), ("encoded", "index_bytes_encoded"),
    ("files", "index_bytes_encoded"), ("speedup_eq", "speedup"),
    ("speedup_lt", "speedup")])
def test_envelope_gates_fail_on_a_planted_fault(chip_smoke, fault, match):
    reps, spooled, files = _envelope_inputs()
    if fault == "bytes_read":
        reps[PAIRS[0]]["bytes_read_measured"] += 1
    elif fault == "encoded":
        reps[PAIRS[1]]["index_bytes_encoded"] -= 1
    elif fault == "files":
        files[PAIRS[0]] += 16
    elif fault == "speedup_eq":
        reps[PAIRS[0]]["gb_per_min_measured"] = 2.0
    else:
        reps[PAIRS[0]]["gb_per_min_measured"] = 1.0
    with pytest.raises(AssertionError, match=match):
        chip_smoke.envelope_gates(reps, spooled, files)


def _steady_inputs():
    load = {"offered": 500, "completed": 500, "rejected": 0}
    report = {"merge_concurrency": 2, "n_merges": 1}
    launches = {"pack": 40, "bm25_blocks": 9, "bm25_blocks_midgrid": 300}
    return load, 12, 10, report, launches


def test_steady_gates_pass(chip_smoke):
    chip_smoke.steady_gates(*_steady_inputs())


@pytest.mark.parametrize("fault", [
    "incomplete", "rejected", "refreshes", "generations", "threads",
    "merges", "pack", "bm25_blocks", "bm25_blocks_midgrid"])
def test_steady_gates_fail_on_a_planted_fault(chip_smoke, fault):
    load, refreshes, gens, report, launches = _steady_inputs()
    if fault == "incomplete":
        load["completed"] -= 1
    elif fault == "rejected":
        load["rejected"] = 1
    elif fault == "refreshes":
        refreshes = 9
    elif fault == "generations":
        gens = 9
    elif fault == "threads":
        report["merge_concurrency"] = 0
    elif fault == "merges":
        report["n_merges"] = 0
    else:
        launches[fault] = 0
    with pytest.raises(AssertionError, match=r"\[steady\] gates"):
        chip_smoke.steady_gates(load, refreshes, gens, report, launches)


def test_wait_for_new_generation_returns_on_a_swap_and_raises_without(
        chip_smoke):
    from types import SimpleNamespace
    ix = SimpleNamespace(searcher=SimpleNamespace(generation=3))
    with pytest.raises(AssertionError, match="no refresh surfaced a change "
                                             "to generation 3"):
        chip_smoke.wait_for_new_generation(ix, 3, 0.05)
    timer = threading.Timer(0.05, lambda: setattr(
        ix, "searcher", SimpleNamespace(generation=4)))
    timer.start()
    try:
        assert chip_smoke.wait_for_new_generation(ix, 3, 10.0) > 0
    finally:
        timer.cancel()


def test_steady_churn_surfaces_each_change_in_its_own_generation(
        chip_smoke):
    """The churn on a CPU indexer with the refresh daemon: every tick
    flushes (SMOKE over 32-doc batches) and every 4th also deletes, and
    each tick ends only when the daemon has swapped in a new generation."""
    from repro_torch.configs.lucene_envelope import SMOKE
    from repro_torch.core.indexer import Indexer
    from repro_torch.data.corpus import TINY, SyntheticCorpus
    corpus = SyntheticCorpus(TINY, doc_buffer_len=SMOKE.doc_len)
    batches = [corpus.batch(i, 32) for i in range(9)]
    ix = Indexer(cfg=SMOKE, device="cpu", refresh_every=0.02)
    gens = []
    try:
        ix.index_batch(batches[0])
        ix.refresh()
        ix.on_refresh.append(lambda s: gens.append(s.generation))
        q = np.stack([np.unique(batches[0])[1:5].astype(np.int32)] * 4)
        churn, state = chip_smoke._steady_churn(ix, batches[1:], q, 10)
        seen = [ix.searcher.generation]
        for _ in range(8):
            churn()
            seen.append(ix.searcher.generation)
        churn()                       # past the last batch: no tick
        assert state.tick == 8 and state.done.is_set()
        assert state.error is None and state.waited_s > 0
        assert len(state.deleted) == 2 * chip_smoke.STEADY_DELETES
        assert len(set(seen)) == 9    # a generation after every tick
        assert len(set(gens)) >= 8
    finally:
        ix.close()


def test_miss_latency_counts_only_uncached_completed_requests(chip_smoke):
    from types import SimpleNamespace as R
    reqs = [R(done=True, cached=True, t_submit=0.0, t_done=0.0)] * 50 + [
        R(done=True, cached=False, t_submit=1.0, t_done=1.0 + ms / 1e3)
        for ms in range(1, 101)] + [
        R(done=False, cached=False, t_submit=0.0, t_done=9.0)]
    got = chip_smoke.miss_latency_ms(reqs)
    want = np.percentile(np.arange(1, 101, dtype=np.float64), [50, 99, 99.9])
    assert got["misses"] == 100
    np.testing.assert_allclose(
        [got["p50_ms"], got["p99_ms"], got["p999_ms"]], want, rtol=1e-9)
    assert chip_smoke.miss_latency_ms(reqs[:50]) == {
        "misses": 0, "p50_ms": 0.0, "p99_ms": 0.0, "p999_ms": 0.0}


def test_check_no_deleted(chip_smoke):
    ids = np.array([[3, 9, -1], [4, 5, 6]])
    assert chip_smoke.check_no_deleted(ids, [7, 8, -1]) == 6
    with pytest.raises(AssertionError, match=r"deleted docs served: \[5\]"):
        chip_smoke.check_no_deleted(ids, [7, 5])


@pytest.fixture(scope="module")
def served():
    """A small CPU index served through a cached scheduler: the cache's
    entries and the snapshot they were computed on."""
    from repro_torch.configs.lucene_envelope import SMOKE
    from repro_torch.core.indexer import Indexer
    from repro_torch.serving.steady import (QueryRequest, QueryScheduler,
                                            ResultCache)
    rng = np.random.default_rng(0)
    ix = Indexer(cfg=SMOKE, device="cpu")
    try:
        toks = rng.integers(1, 4096, (32, 64)).astype(np.int32)
        ix.index_batch(toks)
        ix.index_batch(rng.integers(1, 4096, (32, 64)).astype(np.int32))
        s = ix.refresh()
        cache = ResultCache()
        sched = QueryScheduler(searcher=s, slots=4, max_terms=4, k=5,
                               cache=cache, device="cpu")
        for i in range(40):
            sched.submit(QueryRequest(rid=i, terms=toks[i % 32, i // 32:][
                :4], k=5))
        sched.run_to_completion()
    finally:
        ix.close()
    return dict(cache._store), s


def test_check_cache_entries_pass(chip_smoke, served):
    entries, s = served
    assert chip_smoke.check_cache_entries(entries, s, 5) == len(entries)
    assert len(entries) > 32            # two batches of the check


@pytest.mark.parametrize("fault", ["score", "id", "late_row"])
def test_check_cache_entries_fail_on_a_planted_fault(chip_smoke, served,
                                                     fault):
    """A score a bit off, or an id that does not carry the score it is
    returned with (in the first batch, or in the second)."""
    entries, s = served
    key = list(entries)[35 if fault == "late_row" else 2]
    vals, ids = (a.copy() for a in entries[key])
    if fault == "score":
        vals[1] = np.nextafter(vals[1], np.float32(np.inf))
    else:
        ids[0] = ids[-1] if ids[-1] != ids[0] else ids[0] + 1
    planted = dict(entries)
    planted[key] = (vals, ids)
    with pytest.raises(AssertionError, match="differs from an uncached|"
                                             "score it does not have|"
                                             "repeats"):
        chip_smoke.check_cache_entries(planted, s, 5)


def test_live_file_bytes_equal_the_reports_encoded_bytes(chip_smoke,
                                                         tmp_path):
    """What [envelope] holds ``index_bytes_encoded`` to: the newest
    commit's segment files on the file system, ``.liv`` included; a
    byte more on one file shows."""
    from repro_torch.configs.lucene_envelope import SMOKE
    from repro_torch.core.indexer import Indexer
    from repro_torch.storage import FSDirectory
    cfg = dataclasses.replace(SMOKE, codec="raw")
    rng = np.random.default_rng(1)
    ix = Indexer(cfg=cfg, device="cpu", target_dir=FSDirectory(tmp_path))
    try:
        for _ in range(3):
            ix.index_batch(rng.integers(1, 4096, (16, 64)).astype(np.int32))
        ix.delete([2, 20])
        ix.commit()
        rep = ix.envelope_report()
    finally:
        ix.close()
    got = chip_smoke._live_file_bytes(tmp_path)
    assert got == rep["index_bytes_encoded"] > 0
    assert any(p.suffix == ".liv" for p in tmp_path.iterdir())
    victim = next(p for p in tmp_path.iterdir() if p.suffix == ".pst")
    victim.write_bytes(victim.read_bytes() + b"x")
    assert chip_smoke._live_file_bytes(tmp_path) == got + 1
