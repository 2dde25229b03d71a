"""``chip_smoke.py``'s ``[build]`` gates on the redesigned kernels, read
from ``ptxas -v`` reports shaped as the card's compiler writes them: the
retrieval gate passes when pack, unpack, bm25_blocks (both
instantiations), compact and the four midgrid walk instantiations are
there without spills, and fails when one is missing or spills
(``unpack_kernel`` must not stand in for ``pack_kernel``); the SIMT flash
gate fails when a D = 256 instantiation (f32 or bf16) spills or is
missing; the tensor-core gate when gemma2's D = 256 or moonshot's D = 128
instantiation spills or is missing, or the SASS has no HGMMA. The LM
phases' gates (``lm_gates``) fail on each planted fault, the route-flip
rule accepts only near-ties, ``RouteRecorder`` forces another run's
experts, and ``[moe]`` with ``[moe-checks]`` runs whole on the CPU at
SMOKE width. The pure helpers of the ``[envelope]``, ``[steady]`` and
``[fleet]`` phases (the fixed arrival rate and the uncached probe beside
it, each gate's comparisons, the deleted-doc and result-cache checks,
the live segments' file bytes, the fleet's deletes) pass on sound inputs
and fail on a planted fault each; launch counting and ``ShapeRecorder``
count exactly from 8 threads at once; the ``[fleet]`` phase runs whole
on the CPU with two replica processes. ``[train]``'s gates
(``train_gates``) and ``[train-checks]``' update rule (``update_gate``)
pass on sound inputs and fail on planted faults, a torn save is seen
only without ``save_async``'s host copy, and both phases run whole on
the CPU at SMOKE width."""
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


TC = ("_ZN54_GLOBAL__N__1b2c3d4e_21_flash_attention_tc_cu_5f6a7b8c15flash_tc_"
      "kernelILi{d}ELi{n}EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiiiiiff")
TC_FNS = [TC.format(d=d, n=n) for d, n in ((64, 128), (128, 128), (192, 64),
                                           (256, 64))]


def _tc_check(chip_smoke, monkeypatch, report, sass="HGMMA.64x128x16"):
    import subprocess
    monkeypatch.setattr(_build, "build_report", lambda name: report)
    monkeypatch.setattr(_build, "_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(_build, "_target", lambda name: Path("/x/tc.so"))
    monkeypatch.setattr(subprocess, "run", lambda *a, **kw:
                        types.SimpleNamespace(stdout=sass))
    return chip_smoke.tc_build_check()


def test_tensor_core_gate_passes_without_spills(chip_smoke, monkeypatch):
    got = _tc_check(chip_smoke, monkeypatch, _report(TC_FNS))
    assert got["hgmma"] == 1
    assert set(got["instantiations"]) == {"D64_BN128", "D128_BN128",
                                          "D192_BN64", "D256_BN64"}


@pytest.mark.parametrize("kernel", ["ILi128ELi128E", "ILi256ELi64E"])
@pytest.mark.parametrize("fault", ["spill", "drop"])
def test_tensor_core_gate_fails_on_an_lm_paths_spill_or_missing_kernel(
        chip_smoke, monkeypatch, kernel, fault):
    """gemma2's D = 256 and moonshot's D = 128 instantiations lie on user
    paths: a spill or a missing one fails [build]; the others may not."""
    with pytest.raises(AssertionError, match="missing or spills"):
        _tc_check(chip_smoke, monkeypatch,
                  _report(TC_FNS, **{fault: kernel}))
    _tc_check(chip_smoke, monkeypatch, _report(TC_FNS, spill="ILi192ELi64E"))


def test_tensor_core_gate_fails_without_hgmma(chip_smoke, monkeypatch):
    with pytest.raises(AssertionError, match="no HGMMA"):
        _tc_check(chip_smoke, monkeypatch, _report(TC_FNS), sass="HMMA")


def _lm_gate_inputs():
    from repro_torch.configs.registry import get_arch
    from repro_torch.serving.scheduler import Request
    cfg = get_arch("moonshot-v1-16b-a3b").config
    launches = {"flash_attention_tc": 48 * 3, "flash_attention": 0}
    toks = torch.randint(0, cfg.vocab_size, (4, 16))
    done = [Request(rid=i, prompt=np.ones(5), max_new=16,
                    generated=list(range(16)), done=True) for i in (1, 0)]
    return dict(tag="moe", cfg=cfg, gen_launches=48, launches=launches,
                toks=toks, requests=4, gen=16, done=done, n_sched=2,
                peak_gb=66.0, card_gb=85.0)


def test_lm_gates_pass(chip_smoke):
    chip_smoke.lm_gates(**_lm_gate_inputs())


@pytest.mark.parametrize("fault,match", [
    ("generate_launches", "generate's prefill launched the tensor-core "
                          "flash kernel 47 times"),
    ("sched_launches", "the scheduler's prefills launched"),
    ("simt", "launched the SIMT flash kernel 1 times"),
    ("token_range", "malformed tokens"), ("token_shape", "malformed tokens"),
    ("unfinished", "did not finish every request"),
    ("short", "did not finish every request"),
    ("memory", "peak device memory")])
def test_lm_gates_fail_on_a_planted_fault(chip_smoke, fault, match):
    kw = _lm_gate_inputs()
    if fault == "generate_launches":
        kw["gen_launches"] = 47
    elif fault == "sched_launches":
        kw["launches"]["flash_attention_tc"] -= 1
    elif fault == "simt":
        kw["launches"]["flash_attention"] = 1
    elif fault == "token_range":
        kw["toks"][1, 3] = kw["cfg"].vocab_size
    elif fault == "token_shape":
        kw["toks"] = kw["toks"][:, :15]
    elif fault == "unfinished":
        kw["done"] = kw["done"][:1]
    elif fault == "short":
        kw["done"][0].generated.pop()
    else:
        kw["peak_gb"] = 85.0
    with pytest.raises(AssertionError, match=r"\[moe\] gates: .*" + match):
        chip_smoke.lm_gates(**kw)


def _calls(experts, margin):
    return [{"experts": torch.tensor(e), "margin": torch.tensor(m)}
            for e, m in zip(experts, margin)]


def test_route_flips_accept_only_near_ties(chip_smoke):
    want = _calls([[[0, 1], [2, 5]], [[1, 3], [0, 4]], [[2, 3], [0, 1]]],
                  [[0.1, 0.2], [0.001, 0.3], [0.002, 0.1]])
    same = _calls([[[0, 1], [2, 5]], [[1, 3], [0, 4]], [[2, 3], [0, 1]]],
                  [[0, 0]] * 3)
    assert chip_smoke.route_flips(want, same, 2 ** -8) == []
    near = _calls([[[0, 1], [2, 5]], [[1, 2], [0, 4]], [[2, 4], [0, 1]]],
                  [[0, 0]] * 3)
    assert chip_smoke.route_flips(want, near, 2 ** -8) == [
        (1, pytest.approx(0.001)), (2, pytest.approx(0.002))]
    assert chip_smoke.route_flips(want, near, 2 ** -8, first=True) == [
        (1, pytest.approx(0.001))]
    assert chip_smoke.route_flips(want, near, 2 ** -8, last=True) == []
    clear = _calls([[[0, 1], [2, 6]], [[1, 3], [0, 4]], [[2, 3], [0, 1]]],
                   [[0, 0]] * 3)
    with pytest.raises(AssertionError, match="not a near-tie"):
        chip_smoke.route_flips(want, clear, 2 ** -8, last=True)
    with pytest.raises(AssertionError, match="MoE calls"):
        chip_smoke.route_flips(want, clear[:1], 2 ** -8)


def test_route_recorder_forces_the_other_runs_experts(chip_smoke):
    """A run under ``force`` takes the other run's experts call by call
    (its gates from its own probabilities) and records its own choice."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe, transformer as TF
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").smoke,
                              compute_dtype="float32")
    params = TF.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 12)))
    with chip_smoke.RouteRecorder() as a:
        _, want = TF.prefill(params, toks, cfg)
    rolled = [{**c, "order": (c["order"] + 1) % cfg.n_experts}
              for c in a.calls]
    with chip_smoke.RouteRecorder(force=rolled) as b:
        _, got = TF.prefill(params, toks, cfg)
    assert TF.moe_ffn.__name__ == moe.moe_ffn.__name__ == "moe_ffn"
    assert moe.route.__name__ == "route"
    # layer 0 sees the same input, so records the same own choice
    assert torch.equal(a.calls[0]["experts"], b.calls[0]["experts"])
    assert not torch.allclose(got, want)              # the forced one ran
    with chip_smoke.RouteRecorder(force=a.calls):
        _, same = TF.prefill(params, toks, cfg)
    assert torch.equal(same, want)


def test_phase_moe_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """[moe] and [moe-checks] whole on the CPU at SMOKE width (moonshot,
    bf16 weights, 24-token prompts; the full-width check at 40 tokens).
    The flash op's calls are counted under the kernel a card would take
    at a head dim of 64 or more (bf16: the tensor cores; smoke's D = 16
    takes the SIMT kernel there), so every launch gate applies as on the
    card; the CPU's peak memory is not measured."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer as TF

    def route(dtype, D):
        return "flash_attention_tc" if dtype == torch.bfloat16 \
            else "flash_attention"
    orig = TF.flash_attention

    def counted(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        _build.count_launch(route(q.dtype, q.shape[-1]))
        return out
    monkeypatch.setattr(fops, "route", route)
    monkeypatch.setattr(TF, "flash_attention", counted)
    monkeypatch.setattr(chip_smoke, "LM_FULL_CHECK_LEN", 40)
    argv = ["--mode", "lm", "--arch", "moonshot-v1-16b-a3b", "--param-dtype",
            "bfloat16", "--requests", "4", "--prompt-len", "24", "--gen",
            "16"]
    cpu = torch.device("cpu")
    rec = chip_smoke.ShapeRecorder()
    rep, launches, cfg, params = chip_smoke.phase_lm(cpu, "cpu", rec, argv,
                                                     (24, 6), "moe")
    assert launches == {**launches, "flash_attention_tc": 3 * cfg.n_layers,
                        "flash_attention": 0}
    assert params["layers"]["ffn"]["w_up"].dtype == torch.bfloat16
    assert 0 <= rep["drop_share"] < 1 and rep["peak_gb"] is None
    assert rep["sched_tokens"] == 2 * chip_smoke.SCHED_GEN
    assert rep["active_param_count"] < rep["param_count"]
    out = chip_smoke.phase_lm_checks(cpu, cfg, params, rec, 24,
                                     chip_smoke.MOE_SMOKE_ARCHS)
    assert out["f32_launches"]["flash_attention"] == 2 * cfg.n_layers
    for dtype in ("bfloat16", "float32"):
        chk = out[f"full_decode_vs_prefill_{dtype}"]
        assert chk["dropped"] == 0 and chk["capacity_factor"] == 4.0
        assert set(chk["planted_rms_ratio"]) == {"experts_rolled",
                                                 "position_minus_1"}
        assert chk["moe_rms_ratio"] <= chk["moe_limit"]
        assert min(chk["planted_moe_rms_ratio"].values()) > chk["moe_limit"]
        assert chk["planted_rms_ratio"]["position_minus_1"] > chk["limit"]
    assert set(out["smoke_card_vs_cpu_max_abs"]) == {
        f"{a}/{d}" for a in chip_smoke.MOE_SMOKE_ARCHS
        for d in ("float32", "bfloat16")}


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
    assert rep["oracle_docs"] == 2 * ((chip_smoke.FLEET_BATCHES + 1) * 64
                                      - chip_smoke.FLEET_DELETES)
    assert rep["repair"]["files"] >= 1 and rep["anti_entropy"]["repaired"]
    assert all(l["replicas_current"] == 2 for l in rep["ledgers"])
    assert not list((chip_smoke.ROOT / "build").glob("chip_smoke_fleet_*"))


def _mesh_rank_report(digests, m, **kw):
    rep = {"digests": dict(digests), "packed2_eq_raw": True, "owned": True,
           "launches": {"pack": 2}, "merge_eq_host": True,
           "stats": {"sent": 10, "recv": 10 + (2 * m - 1) * 3, "dropped": 0},
           "coords": {"data": 0, "model": m}}
    rep.update(kw)
    return rep


def _mesh_inputs():
    want = [{"run.term": f"h{r}", "packed_bytes": "1.0"} for r in range(4)]
    ranks = [_mesh_rank_report(w, r % 2) for r, w in enumerate(want)]
    want1 = {"run.term": "w1", "packed_bytes": "2.0"}
    world1 = _mesh_rank_report(want1, 0)
    del world1["packed2_eq_raw"]
    return ranks, want, world1, want1


def test_mesh_gates_pass(chip_smoke):
    chip_smoke.mesh_gates(*_mesh_inputs())


@pytest.mark.parametrize("fault,match", [
    ("digest", r"rank 2: \['run.term'\] differ"),
    ("world1_digest", r"world 1: \['packed_bytes'\] differ"),
    ("raw", "rank 1: packed2 != raw"), ("owner", "rank 3: a term off"),
    ("pack", "rank 0: pack never launched"),
    ("world1_pack", "world 1: pack never launched"),
    ("merge", "rank 2: the mesh merge"), ("conserve", "sent 40 != recv")])
def test_mesh_gates_fail_on_a_planted_fault(chip_smoke, fault, match):
    ranks, want, world1, want1 = _mesh_inputs()
    if fault == "digest":
        ranks[2]["digests"]["run.term"] = "x"
    elif fault == "world1_digest":
        world1["digests"]["packed_bytes"] = "2.5"
    elif fault == "raw":
        ranks[1]["packed2_eq_raw"] = False
    elif fault == "owner":
        ranks[3]["owned"] = False
    elif fault == "pack":
        ranks[0]["launches"] = {"pack": 0}
    elif fault == "world1_pack":
        world1["launches"] = {}
    elif fault == "merge":
        ranks[2]["merge_eq_host"] = False
    else:
        ranks[0]["stats"]["recv"] += 1
    with pytest.raises(AssertionError, match=match):
        chip_smoke.mesh_gates(ranks, want, world1, want1)


def test_mesh_digests_see_one_flipped_bit(chip_smoke):
    from repro_torch.configs.lucene_envelope import SMOKE
    from repro_torch.core.indexer import index_step_loopback
    rng = np.random.default_rng(0)
    blocks = [rng.integers(0, 300, (SMOKE.docs_per_shard, SMOKE.doc_len)
                           ).astype(np.int32) for _ in range(2)]
    a, b = (index_step_loopback(SMOKE, {"data": 1, "model": 2}, blocks,
                                SMOKE.doc_len) for _ in range(2))
    assert chip_smoke.mesh_digests(a[0]) == chip_smoke.mesh_digests(b[0])
    assert chip_smoke.mesh_digests(a[0]) != chip_smoke.mesh_digests(a[1])
    b[0]["packed_pos"].view(-1)[7] ^= 1 << 30
    diff = [f for f, h in chip_smoke.mesh_digests(a[0]).items()
            if chip_smoke.mesh_digests(b[0])[f] != h]
    assert diff == ["packed_pos"]
    assert set(chip_smoke.mesh_digests(a[0])) >= {
        "run.postings_term", "stats.dropped", "bw_docs", "packed_bytes"}


def test_mesh_merge_inputs_have_ties_and_split_over_4(chip_smoke):
    vals, ids, k = chip_smoke.mesh_merge_inputs(np.random.default_rng(3))
    S, B, _ = vals.shape
    assert (S, B, k) == chip_smoke.MESH_MERGE and S % 4 == 0
    assert (np.diff(vals, axis=2) <= 0).all() and (ids[:, :, -1] == -1).all()
    flat = vals[:, 0, :-2].ravel()
    assert len(np.unique(flat)) < len(flat)       # ties across shards


def test_phase_mesh_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """The whole [mesh] phase on the CPU at SMOKE width with the packed2
    payload (CONFIG replaced here; the ranks get it from this process):
    4 spawned ranks over gloo, world 1 over gloo in this process, the
    plain loopbacks beside them. No kernel launches on the
    CPU, so the gates get the reports and are checked here without the
    launch gates."""
    from repro_torch.configs import lucene_envelope
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    monkeypatch.syspath_prepend(str(ROOT))
    gated = []
    monkeypatch.setattr(chip_smoke, "mesh_gates", lambda *a: gated.append(a))
    monkeypatch.setattr(lucene_envelope, "CONFIG", dataclasses.replace(
        lucene_envelope.SMOKE, shuffle_payload="packed2"))
    rep, launches = chip_smoke.phase_mesh(
        torch.device("cpu"), "cpu", chip_smoke.ShapeRecorder())
    (ranks, want, world1, want1), = gated
    for r in ranks:
        r["launches"] = {"pack": 2}
    world1["launches"] = {"pack": 2}
    chip_smoke.mesh_gates(ranks, want, world1, want1)
    assert not any(launches.values())
    assert [r["coords"] for r in rep["ranks"]] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]
    for r in rep["ranks"]:
        t = r["timing"]
        assert 2 * t["raw"]["shuffle_bytes"] \
            == 3 * t["packed2"]["shuffle_bytes"]
        assert not t["packed2"]["staged"] and t["packed2"]["step_ms"] > 0
    assert sum(r["stats"]["sent"] for r in rep["ranks"]) > 0
    assert rep["world1"]["backend"] == "gloo"
    assert set(rep["launches_children"]) == {f"rank{r}" for r in range(4)}
    assert not list((chip_smoke.ROOT / "build").glob("chip_smoke_mesh_*"))


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


# --------------------------------------------------------------------------
# [train] and [train-checks]
# --------------------------------------------------------------------------

def test_train_gates_pass(chip_smoke):
    chip_smoke.train_gates("train", [12.5, 11.0, 12.6, 10.2],
                           [3.0, 2.0, 1.5, 1.1])


@pytest.mark.parametrize("fault,match", [
    ("rose", "did not fall"), ("flat", "did not fall"),
    ("nan_loss", "not finite"), ("inf_norm", "not finite"),
    ("empty", "not finite")])
def test_train_gates_fail_on_a_planted_fault(chip_smoke, fault, match):
    losses, norms = [12.5, 11.0, 10.2], [3.0, 2.0, 1.5]
    if fault == "rose":
        losses[-1] = 12.6
    elif fault == "flat":
        losses[-1] = losses[0]
    elif fault == "nan_loss":
        losses[1] = float("nan")
    elif fault == "inf_norm":
        norms[2] = float("inf")
    else:
        losses, norms = [], []
    with pytest.raises(AssertionError, match=r"\[train\] gates: .*" + match):
        chip_smoke.train_gates("train", losses, norms)


def _updates(n=1000, lr=3e-4, steps=2):
    g = torch.Generator().manual_seed(0)
    before = [torch.randn(n, generator=g)]
    step = torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0)
    want = [before[0] + lr * steps * step]
    return before, want, step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_gate_passes_within_its_limits(chip_smoke, dtype):
    before, want, step = _updates()
    got = [want[0] + 1e-9]
    out = chip_smoke.update_readings(got, want, before)
    chip_smoke.update_gate(out, dtype, 2, 3e-4)
    assert out["share_off"] == 0.0 and out["update_rms_ratio"] < 1e-3
    if dtype == "bfloat16":  # a few gradients within rounding of 0
        got = [want[0].clone()]
        got[0][:5] -= 2 * 3e-4 * 2 * step[:5]
        chip_smoke.update_gate(chip_smoke.update_readings(got, want, before),
                               dtype, 2, 3e-4)


@pytest.mark.parametrize("dtype,fault", [
    ("float32", "one_flip"), ("bfloat16", "many_flips"),
    ("bfloat16", "past_the_cards_share"),
    ("float32", "too_far"), ("bfloat16", "too_far"),
    ("bfloat16", "sign_flipped")])
def test_update_gate_fails_on_a_planted_fault(chip_smoke, dtype, fault):
    before, want, step = _updates()
    got = [want[0].clone()]
    if fault == "one_flip":
        got[0][0] -= 2 * 3e-4 * 2 * step[0]
    elif fault == "many_flips":
        got[0][:30] -= 2 * 3e-4 * 2 * step[:30]
    elif fault == "past_the_cards_share":
        got[0][:101] -= 2 * 3e-4 * 2 * step[:101]
    elif fault == "too_far":
        got[0][7] += 1.3 * 4 * 3e-4
    else:
        got = [before[0] - (want[0] - before[0])]
    flips = chip_smoke.TRAIN_SMOKE_FLIPS if fault == "past_the_cards_share" \
        else chip_smoke.STEP_FLIPS
    with pytest.raises(AssertionError, match="update differs"):
        chip_smoke.update_gate(chip_smoke.update_readings(got, want, before),
                               dtype, 2, 3e-4, flips=flips)


def test_torn_save_is_seen_only_without_the_host_copy(chip_smoke, tmp_path):
    cpu = torch.device("cpu")
    assert not chip_smoke.torn_save_caught(cpu, tmp_path / "a", fault=False)
    assert chip_smoke.torn_save_caught(cpu, tmp_path / "b", fault=True)


def test_phase_train_rehearsed_on_the_cpu(chip_smoke, tmp_path, request):
    """[train] and [train-checks] whole on the CPU at SMOKE width:
    stablelm SMOKE, 6 steps of 2 x 64 tokens through ``launch.train``'s
    loop (at lr 3e-3: at this width lr 3e-4 moves the loss less than one
    batch differs from the next), the sign-flipped run caught, the
    gradient check's sound reading within its limit and both planted
    faults above it; then every check of [train-checks] (the card is the
    CPU here). No kernel launches."""
    from repro_torch.configs.registry import get_arch
    cpu = torch.device("cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    request.addfinalizer(lambda: torch.set_num_threads(prev))
    _build.reset_launches()
    rep = chip_smoke.phase_train(
        cpu, "cpu", get_arch("stablelm-12b").smoke,
        ["--steps", "6", "--batch", "2", "--seq", "64", "--lr", "3e-3",
         "--log-every", "1"], grad_layers=2, grad_seq=64)
    assert rep["flipped_caught"] and len(rep["losses"]) == 6
    assert rep["flipped_losses"][-1] > rep["flipped_losses"][0]
    assert rep["peak_gb"] is None and rep["tokens_per_step"] == 128
    chk = rep["grad_check"]
    assert chk["sound"] <= chk["limit"] == chip_smoke.TRAIN_GRAD_LIMIT
    assert min(chk["causal_mask_dropped"], chk["rope_q_plus_1"]) \
        > chk["limit"]
    out = chip_smoke.phase_train_checks(cpu, tmp_path)
    assert set(out) == {f"{a}/{d}" for a in chip_smoke.TRAIN_SMOKE_ARCHS
                        for d in ("float32", "bfloat16")} | {
        "microbatch_4_vs_1", "resume_at_3_vs_whole", "torn_save"}
    assert out["resume_at_3_vs_whole"]["start"] == 3
    assert out["torn_save"] == {"sound": False, "host_copy_removed": True}
    assert not any(_build.LAUNCHES.values())
