"""The port's envelope model, tokenizer and double-buffered reader against
the JAX package's: ``calibrate`` (params, media, the fitted table and the
residuals it minimised, with and without measured runs), ``predict``,
``stage_times`` and ``predict_table1`` for every media pair, and
``measured_run_from_report`` equal within 1e-12 relative (the same numpy
and scipy on the same inputs); the paper's claims of
``tests/test_envelope.py`` asserted on the port's module; the FNV
tokenizer exactly equal; the reader's batches and ``ReadStats`` exactly
equal."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core import envelope as jenv
from repro.core import tokenize as jtok
from repro.data.corpus import TINY as JTINY, SyntheticCorpus as JCorpus
from repro.io.reader import DoubleBufferedReader as JReader
from repro_torch.core import envelope as tenv
from repro_torch.core import tokenize as ttok
from repro_torch.data.corpus import TINY, SyntheticCorpus
from repro_torch.io.reader import DoubleBufferedReader

REL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(a, b, what=""):
    """Equal within REL, recursively over dicts, tuples and dataclasses;
    strings and bools exactly."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _close(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{what}[{i}]")
    elif isinstance(a, (bool, str)) or a is None:
        assert a == b, what
    else:
        assert b == pytest.approx(a, rel=REL, abs=0.0), what


def _measured(env):
    """Two measured runs in the paper's units, as an envelope report of a
    throttled nas -> ssd and ssd -> ssd pair gives them."""
    reps = {("nas", "ssd"): {"bytes_read_measured": 3_145_728 * 64,
                             "index_bytes_encoded": 98_765_432,
                             "t_envelope_measured_s": 0.61,
                             "t_io_measured_s": 0.5},
            ("ssd", "ssd"): {"bytes_read_measured": 3_145_728 * 64,
                             "index_bytes_encoded": 98_765_432,
                             "t_envelope_measured_s": 0.93,
                             "t_io_measured_s": 0.9}}
    return [env.measured_run_from_report(s, t, r, "t_io_measured_s")
            for (s, t), r in reps.items()]


@pytest.fixture(scope="module")
def calibrated():
    return {w: (jenv.calibrate(measured=_measured(jenv) if w else (),
                               measured_weight=w or 1.0),
                tenv.calibrate(measured=_measured(tenv) if w else (),
                               measured_weight=w or 1.0))
            for w in (0.0, 0.1)}


def _residuals(env, media, p, measured, weight):
    """The residual vector ``calibrate`` minimises, at its solution."""
    table = env.predict_table1(media, p)
    res = [np.log(v["pred"] / v["actual"]) for v in table.values()]
    for run in measured:
        src, tgt = run.media_names()
        col = env.Collection("m", run.raw_gb, run.index_gb, 0.0)
        pred = env.stage_times(media[src], media[tgt], col, p)["total"]
        res.append(weight * np.log(pred / run.seconds))
    return np.array(res)


@pytest.mark.parametrize("weight", [0.0, 0.1])
def test_calibrate_matches_jax(calibrated, weight):
    (jm, jp, jt), (tm, tp, tt) = calibrated[weight]
    _close(dataclasses.asdict(jp), dataclasses.asdict(tp), "params")
    _close({k: dataclasses.asdict(v) for k, v in jm.items()},
           {k: dataclasses.asdict(v) for k, v in tm.items()}, "media")
    _close(jt, tt, "table")
    meas = (_measured(jenv), _measured(tenv)) if weight else ((), ())
    w = weight or 1.0
    _close(list(_residuals(jenv, jm, jp, meas[0], w)),
           list(_residuals(tenv, tm, tp, meas[1], w)), "residuals")


@pytest.mark.parametrize("fitted", [False, True])
def test_predict_and_stage_times_every_pair_match_jax(calibrated, fitted):
    (jm, jp, _), (tm, tp, _) = calibrated[0.0] if fitted else (
        (None, None, None), (None, None, None))
    _close(jenv.predict_table1(jm, jp), tenv.predict_table1(tm, tp),
           "predict_table1")
    for src, tgt in itertools.product(jenv.MEDIA, repeat=2):
        for jc, tc in ((jenv.CW09B, tenv.CW09B), (jenv.CW12B, tenv.CW12B)):
            _close(jenv.predict(src, tgt, jc, jm, jp),
                   tenv.predict(src, tgt, tc, tm, tp), f"{src}->{tgt}")
            _close(jenv.stage_times((jm or jenv.MEDIA)[src],
                                    (jm or jenv.MEDIA)[tgt], jc,
                                    jp or jenv.EnvelopeParams()),
                   tenv.stage_times((tm or tenv.MEDIA)[src],
                                    (tm or tenv.MEDIA)[tgt], tc,
                                    tp or tenv.EnvelopeParams()),
                   f"stage_times {src}->{tgt}")


def test_measured_run_from_report_matches_jax():
    for key in ("t_envelope_measured_s", "t_io_measured_s"):
        rep = {"bytes_read_measured": 123_456_789,
               "index_bytes_encoded": 45_678_901, "t_envelope_measured_s":
               1.25, "t_io_measured_s": 0.75}
        j = jenv.measured_run_from_report("nas", "disk", rep, key)
        t = tenv.measured_run_from_report("nas", "disk", rep, key)
        _close(j, t, key)
        assert j.media_names() == t.media_names() == ("ceph", "xfs")
    assert tenv.PROFILE_TO_MEDIA == jenv.PROFILE_TO_MEDIA
    assert tenv.TABLE1 == jenv.TABLE1


# the paper's claims (tests/test_envelope.py), on the port's module

def test_fit_quality(calibrated):
    _, _, table = calibrated[0.0][1]
    errs = [abs(v["err"]) for v in table.values()]
    assert np.mean(errs) < 0.15 and np.max(errs) < 0.30


def test_claim_media_spread_3x(calibrated):
    _, _, table = calibrated[0.0][1]
    c9 = [v["pred"] for k, v in table.items() if k[2] == "CW09b"]
    assert 2.0 < max(c9) / min(c9) < 3.5


def test_claim_write_bound_on_ssd(calibrated):
    media, p, table = calibrated[0.0][1]
    for src in ("ceph", "xfs"):
        assert table[(src, "ssd", "CW09b")]["bound"] == "write"
    t = table[("xfs", "ssd", "CW09b")]["pred"]
    assert 0.4 < tenv.CW09B.index_gb * p.alpha / t < 0.65


def test_claim_zfs_slower_target_than_xfs(calibrated):
    media, _, table = calibrated[0.0][1]
    ratio = table[("ceph", "zfs", "CW09b")]["pred"] \
        / table[("ceph", "xfs", "CW09b")]["pred"]
    assert 1.2 < ratio < 1.7
    assert media["xfs"].write_bw > media["zfs"].write_bw


def test_claim_isolation_beats_sharing(calibrated):
    _, _, table = calibrated[0.0][1]
    shared = table[("ssd", "ssd", "CW09b")]["pred"]
    assert shared > table[("ceph", "ssd", "CW09b")]["pred"]
    assert shared > table[("xfs", "ssd", "CW09b")]["pred"]
    assert table[("ssd", "ssd", "CW09b")]["bound"] == "shared-io"


def test_claim_amplification_plausible(calibrated):
    _, p, _ = calibrated[0.0][1]
    assert 2.0 < p.alpha < 3.5


def test_envelope_monotonic_in_bandwidth():
    p = tenv.EnvelopeParams()
    base = tenv.predict("ceph", "ssd", tenv.CW09B, p=p)["total"]
    faster = dict(tenv.MEDIA)
    faster["ssd"] = dataclasses.replace(tenv.MEDIA["ssd"], write_bw=1.0)
    assert tenv.predict("ceph", "ssd", tenv.CW09B, media=faster,
                        p=p)["total"] <= base


TEXTS = ["Hello, World! hello", "a b c", "d", "", "   ,,, ;; ",
         "Top-10 results: 42 docs, 3.14159 GB/min (CW09b/CW12b)",
         "UPPER lower MiXeD 007bond x86_64 e-mail@host.org",
         "naïve café — Straße 東京 ñandú δ 😀 tab\tnew\nline"]


@pytest.mark.parametrize("bits", [8, 12, 16, 20])
def test_tokenizer_matches_jax(bits):
    for text in TEXTS:
        assert ttok.tokenize_text(text, bits) == jtok.tokenize_text(text,
                                                                    bits)
        for tok in ttok._SPLIT.split(text.lower()):
            if tok:
                assert ttok.fnv1a(tok) == jtok.fnv1a(tok)
                assert ttok.hash_term(tok, bits) == jtok.hash_term(tok,
                                                                   bits)
    for doc_len in (1, 4, 64):
        t = ttok.docs_to_buffer(TEXTS, doc_len, bits)
        j = jtok.docs_to_buffer(TEXTS, doc_len, bits)
        assert t.dtype == j.dtype == np.int32 and t.shape == j.shape
        np.testing.assert_array_equal(t, j)
    ids = ttok.tokenize_text("Hello, World! hello", bits)
    assert len(ids) == 3 and ids[0] == ids[2] and ids[0] != ids[1]
    assert all(0 < i < (1 << bits) for i in ids)


@pytest.mark.parametrize("media,depth", [("ceph", 2), ("ssd", 1),
                                         ("zfs", 3)])
def test_double_buffered_reader_matches_jax(media, depth):
    tc, jc = (SyntheticCorpus(TINY, doc_buffer_len=64),
              JCorpus(JTINY, doc_buffer_len=64))
    t = DoubleBufferedReader(lambda i: tc.batch(i, 16), 5, media=media,
                             depth=depth)
    j = JReader(lambda i: jc.batch(i, 16), 5, media=media, depth=depth)
    got, want = list(t), list(j)
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(5))
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.stats.batches == 5 and t.stats.modeled_s > 0
