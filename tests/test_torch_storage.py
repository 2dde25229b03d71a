"""Port parity of the durable storage layer (``repro_torch.storage``)
against the JAX package's ``repro.storage``, on the CPU:

  * every codec's frames are byte-identical to the JAX package's, each
    package decodes the other's frames to equal segments, and torn,
    truncated or bit-flipped frames raise ``CorruptSegment`` in both;
  * commits one package writes, the other reads back to the same
    segments (and the port resumes a JAX-written index with its WAL);
  * recovery — torn and uncommitted files, a crash between an acked add
    and its flush (WAL replay), transient faults under a retry policy, a
    scrubber sweep that finds a flipped bit — ends in the same live state
    as the JAX package's on the same sequence;
  * a kernel that fails inside recovery fails recovery: it is never
    mistaken for a torn file.

Inputs come from numpy seeds; equality is exact everywhere."""
import contextlib
import dataclasses
import io
import threading

import numpy as np
import pytest
import torch

from repro.configs.lucene_envelope import SMOKE as J_SMOKE
from repro.core.indexer import DistributedIndexer
from repro.core.segments import Segment as JSegment
from repro.data import corpus as jcorpus
from repro.storage import codec as jcodec
from repro.storage import commit as jcommit
from repro.storage import directory as jdir
from repro.storage import retry as jretry
from repro.storage import scrub as jscrub
from repro_torch.configs.lucene_envelope import SMOKE
from repro_torch.core.indexer import Indexer
from repro_torch.core.segments import Segment
from repro_torch.data import corpus as tcorpus
from repro_torch.launch import serve as tserve
from repro_torch.storage import codec as tcodec
from repro_torch.storage import commit as tcommit
from repro_torch.storage import directory as tdir
from repro_torch.storage import retry as tretry
from repro_torch.storage import scrub as tscrub

CODECS = ("raw", "pfor", "adaptive", "pef", "auto")
SEG_ARRAYS = ("terms", "term_start", "docs", "tf", "positions", "pos_start",
              "doc_ids", "doc_len")
FAST = dict(base_delay_s=1e-5, max_delay_s=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(seed, variant):
    """A random valid segment's arrays: sorted unique terms, postings
    sorted by (term, doc), increasing positions per posting; its streams
    span up to 6 128-lane blocks and reach wide bit widths. ``big``: the
    largest doc id is 2^32 - 1; ``huge``: doc ids beyond uint32;
    ``reorder``: a BP doc permutation rides the doc table."""
    rng = np.random.default_rng(seed)
    n_docs, n_terms = 300, 6
    doc_ids = np.sort(rng.choice(1 << 20, n_docs, replace=False))
    if variant == "big":
        doc_ids[-1] = (1 << 32) - 1
    if variant == "huge":
        doc_ids = doc_ids + (1 << 40)
    doc_len = rng.integers(1, 3000, n_docs)
    terms = np.sort(rng.choice(1 << 22, n_terms, replace=False))
    df = rng.integers(1, 60, n_terms)
    docs = np.concatenate([np.sort(rng.choice(doc_ids, d, replace=False))
                           for d in df])
    tf = rng.integers(1, 3, docs.size)
    tf[rng.integers(0, docs.size)] = 200
    positions = np.concatenate([np.sort(rng.choice(1 << 18, t,
                                                   replace=False))
                                for t in tf])
    kw = dict(terms=terms, term_start=np.concatenate([[0], np.cumsum(df)]),
              docs=docs, tf=tf,
              pos_start=np.concatenate([[0], np.cumsum(tf)]),
              positions=positions, doc_ids=doc_ids, doc_len=doc_len,
              generation=int(rng.integers(0, 5)))
    kw = {k: (np.asarray(v, np.int64) if k != "generation" else v)
          for k, v in kw.items()}
    if variant == "reorder":
        kw["reorder"] = rng.permutation(n_docs).astype(np.int64)
    return kw


def _both(seed, variant):
    kw = _arrays(seed, variant)
    return JSegment(**kw), Segment(**{k: (v.copy() if hasattr(v, "copy")
                                          else v) for k, v in kw.items()})


def _assert_seg_equal(a, b):
    for f in SEG_ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert int(a.generation) == int(b.generation)
    for f in ("deletes", "reorder"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=f)


def _live_state(segs):
    """(live doc id -> length) and the sorted (term, doc, tf) postings of
    live docs: the searchable content of a segment set."""
    lens, posts = {}, []
    for s in segs:
        live = np.ones(s.n_docs, bool) if s.deletes is None else ~s.deletes
        lens.update(zip(s.doc_ids[live].tolist(), s.doc_len[live].tolist()))
        tix = np.repeat(s.terms, np.diff(s.term_start))
        keep = np.isin(s.docs, s.doc_ids[live])
        posts.append(np.stack([tix[keep], s.docs[keep], s.tf[keep]], 1))
    p = np.concatenate(posts) if posts else np.zeros((0, 3), np.int64)
    return lens, p[np.lexsort(p.T[::-1])]


def _assert_same_live(a, b):
    la, pa = _live_state(a)
    lb, pb = _live_state(b)
    assert la == lb
    np.testing.assert_array_equal(pa, pb)


def _tokens(rng, n=16):
    """A batch of short docs (1-4 tokens, zero-padded to the buffer), so
    a flushed segment's streams fit one 128-lane block and a merged one's
    a few: the JAX package compiles its pack/unpack per block count."""
    toks = rng.integers(1, 4096, (n, 64)).astype(np.int32)
    toks[np.arange(64)[None, :] >= rng.integers(1, 5, n)[:, None]] = 0
    return toks


def _assert_same_files(a, b):
    """Two directories hold the same files, byte for byte, except for the
    wall-clock stamp inside commit manifests."""
    assert sorted(a.list_files()) == sorted(b.list_files())
    for name in a.list_files():
        da, db = a.read_file(name), b.read_file(name)
        if jcommit.MANIFEST_RE.match(name):
            ma, mb = (tcommit.read_commit(a, name),
                      tcommit.read_commit(b, name))
            ma.pop("ts"), mb.pop("ts")
            assert ma == mb, name
        else:
            assert da == db, name


def _ram_copy(src, cls):
    out = cls()
    out._files = dict(src._files)
    return out


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "reorder", "big", "huge"])
@pytest.mark.parametrize("codec", CODECS)
def test_codec_frames_byte_identical(codec, variant):
    jseg, tseg = _both(7, variant)
    if variant == "huge" and codec in ("pfor", "adaptive"):
        with pytest.raises(ValueError):
            jcodec.encode_segment(jseg, codec)
        with pytest.raises(ValueError):
            tcodec.encode_segment(tseg, codec, device="cpu")
        return
    jf = jcodec.encode_segment(jseg, codec)
    tf = tcodec.encode_segment(tseg, codec, device="cpu")
    assert list(jf) == list(tf)
    for sfx in jf:
        assert jf[sfx] == tf[sfx], sfx
    # each package decodes the other's frames
    _assert_seg_equal(tcodec.decode_segment(jf, device="cpu"), jseg)
    _assert_seg_equal(jcodec.decode_segment(tf), tseg)


@pytest.mark.parametrize("codec", CODECS)
def test_codec_streams_byte_identical_at_edges(codec):
    rng = np.random.default_rng(3)
    streams = [np.zeros(0, np.int64), np.zeros(300, np.int64),
               np.full(100, (1 << 32) - 1, np.int64),
               rng.integers(0, 1 << 31, 257),
               np.concatenate([rng.integers(0, 4, 299), [1 << 30]])]
    for a in streams:
        enc = tcodec._enc_stream(a, codec, "cpu")
        assert enc == jcodec._enc_stream(a, codec)
        got, end = tcodec._dec_stream(enc, 0, "cpu")
        assert end == len(enc)
        np.testing.assert_array_equal(got, a)
        np.testing.assert_array_equal(
            jcodec.decode_stream_naive(enc, 0)[0], a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torn_truncated_and_flipped_frames_raise(seed):
    rng = np.random.default_rng(seed)
    jseg, tseg = _both(seed, "reorder")
    codec = CODECS[seed + 1]
    files = tcodec.encode_segment(tseg, codec, device="cpu")
    for sfx, data in files.items():
        cuts = [0, 8, 20, len(data) // 2, len(data) - 1]
        bits = rng.integers(0, len(data) * 8, 4)
        bad = [data[:c] for c in cuts]
        for bit in bits:
            flip = bytearray(data)
            flip[bit // 8] ^= 1 << (bit % 8)
            bad.append(bytes(flip))
        for b in bad:
            broken = {**files, sfx: b}
            with pytest.raises(tcodec.CorruptSegment):
                tcodec.decode_segment(broken, device="cpu")
            with pytest.raises(jcodec.CorruptSegment):
                jcodec.decode_segment(broken)
        with pytest.raises(tcodec.CorruptSegment):
            tcodec.decode_segment({k: v for k, v in files.items()
                                   if k != sfx}, device="cpu")


def test_liveness_frames_roundtrip():
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 8, 300):
        mask = rng.random(n) < 0.3
        data = tcodec.encode_liveness(mask)
        assert data == jcodec.encode_liveness(mask)
        np.testing.assert_array_equal(tcodec.decode_liveness(data, n), mask)
        np.testing.assert_array_equal(jcodec.decode_liveness(data, n), mask)
        with pytest.raises(tcodec.CorruptSegment):
            tcodec.decode_liveness(data, n + 1)
        with pytest.raises(tcodec.CorruptSegment):
            tcodec.decode_liveness(data[:-3], n)


def test_spooled_source_matches_reference():
    spec = dataclasses.replace(jcorpus.TINY, n_docs=64)
    jd, td = jdir.RAMDirectory(), tdir.RAMDirectory()
    nj = jcorpus.spool_corpus(jcorpus.SyntheticCorpus(spec, 64), jd, 3, 16)
    nt = tcorpus.spool_corpus(tcorpus.SyntheticCorpus(
        dataclasses.replace(tcorpus.TINY, n_docs=64), 64), td, 3, 16)
    assert nj == nt and jd._files == td._files
    ix = Indexer(cfg=SMOKE, device="cpu", source_dir=td)
    assert ix.index_spooled() == 48
    got = ix.refresh()
    assert got.n_docs == 48
    for (i, a), (j, b) in zip(jcorpus.iter_spooled(jd),
                              tcorpus.iter_spooled(td)):
        assert i == j
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# commits across packages
# ---------------------------------------------------------------------------

def _lifecycle(ix, rng, n_batches=5):
    """Index, delete, update and commit on either package's indexer;
    returns the acked tokens."""
    batches = [_tokens(rng) for _ in range(n_batches)]
    for b in batches[:3]:
        ix.index_batch(b)
    ix.commit()
    for b in batches[3:]:
        ix.index_batch(b)
    ix.delete([1, 17, 40, 71])
    ix.update(5, batches[0][3])
    ix.commit()
    return batches


def test_port_commit_reads_back_in_reference(tmp_path):
    ix = Indexer(cfg=SMOKE, device="cpu",
                 target_dir=tdir.FSDirectory(str(tmp_path)), wal=True)
    _lifecycle(ix, np.random.default_rng(5))
    live = ix.merger.live_segments()
    ix.close()
    gen_j, segs_j = jcommit.open_latest(jdir.FSDirectory(str(tmp_path)))
    gen_t, segs_t = tcommit.open_latest(tdir.FSDirectory(str(tmp_path)),
                                        device="cpu")
    assert gen_j == gen_t == 2 and len(segs_j) == len(segs_t) == len(live)
    for a, b, c in zip(segs_j, segs_t, live):
        _assert_seg_equal(a, b)
        _assert_seg_equal(b, c)
    assert (jcommit.read_commit(jdir.FSDirectory(str(tmp_path)),
                                "segments_2")["segments"]
            == tcommit.read_commit(tdir.FSDirectory(str(tmp_path)),
                                   "segments_2")["segments"])


def test_reference_commit_reads_back_and_resumes_in_port(tmp_path):
    jix = DistributedIndexer(cfg=J_SMOKE,
                             target_dir=jdir.FSDirectory(str(tmp_path)),
                             wal=True)
    rng = np.random.default_rng(6)
    _lifecycle(jix, rng)
    tail = _tokens(rng)
    jix.index_batch(tail)   # acked, flushed, never committed: WAL only
    jix.close()
    gen_j, segs_j = jcommit.open_latest(jdir.FSDirectory(str(tmp_path)))
    gen_t, segs_t = tcommit.open_latest(tdir.FSDirectory(str(tmp_path)),
                                        device="cpu")
    assert gen_j == gen_t == 2
    for a, b in zip(segs_j, segs_t):
        _assert_seg_equal(a, b)
    # the port resumes the JAX-written index and replays its WAL
    ix = Indexer(cfg=SMOKE, device="cpu",
                 target_dir=tdir.FSDirectory(str(tmp_path)), wal=True)
    assert ix._wal.replayed == 1
    _assert_same_live(ix.merger.live_segments(),
                      jix.merger.live_segments())
    assert ix._next_doc == jix._next_doc
    ix.close()


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------

def test_recovery_ignores_torn_and_uncommitted_files():
    """Both packages walk the same damaged directory to the same commit,
    the same segments and the same cleanup."""
    rng = np.random.default_rng(9)
    ram = tdir.RAMDirectory()
    ix = Indexer(cfg=SMOKE, device="cpu", target_dir=ram)
    for _ in range(2):
        ix.index_batch(_tokens(rng))
    ix.commit()
    first = dict(ram._files)
    ix.index_batch(_tokens(rng))
    ix.delete([3])
    ix.commit()
    ix.close()
    # commit 1 comes back, commit 2's newest segment is torn mid-file
    ram._files.update(first)
    newest = max(n.split(".")[0] for n in ram.list_files()
                 if n.endswith(".pst"))
    data = ram.read_file(newest + ".pst")
    ram.write_file(newest + ".pst", data[:len(data) // 2])
    ram.write_file("segments_9", b"not a manifest at all")
    ram.write_file("segments_7.tmp", b"\x00" * 8)
    ram.write_file("s000000ff.dict", b"RSEGtorn")
    ram.write_file("batch_000000", b"spooled source data")
    jram, tram = (_ram_copy(ram, jdir.RAMDirectory),
                  _ram_copy(ram, tdir.RAMDirectory))
    gen_j, segs_j = jcommit.open_latest(jram)
    gen_t, segs_t = tcommit.open_latest(tram, device="cpu")
    assert gen_j == gen_t == 1
    for a, b in zip(segs_j, segs_t):
        _assert_seg_equal(a, b)
    gen_j, segs_j, info_j = jcommit.open_latest_degraded(jram)
    gen_t, segs_t, info_t = tcommit.open_latest_degraded(tram, "cpu")
    assert gen_j == gen_t == 2
    assert info_j.quarantined == info_t.quarantined == {newest: 16}
    _assert_same_live(segs_j, segs_t)
    store_j, rec_j = jcommit.SegmentStore.open(jram)
    store_t, rec_t = tcommit.SegmentStore.open(tram, device="cpu")
    assert store_j.gen == store_t.gen == 1
    assert (store_j.recovery.commits_skipped
            == store_t.recovery.commits_skipped == 2)
    assert sorted(jram.list_files()) == sorted(tram.list_files())
    _assert_same_live(rec_j, rec_t)


@pytest.mark.parametrize("budget_mb", [0, 64])
def test_crash_between_ack_and_flush_replays_like_reference(budget_mb):
    """A kill between an acked add (and delete) and its commit: the WAL
    replay restores every acked doc, and the recovered live set equals the
    JAX package's on the same sequence — and the JAX package replaying
    the port's log, too."""
    rng = np.random.default_rng(10 + budget_mb)
    committed, acked = _tokens(rng), _tokens(rng, 8)
    jcfg = dataclasses.replace(J_SMOKE, flush_budget_mb=budget_mb)
    tcfg = dataclasses.replace(SMOKE, flush_budget_mb=budget_mb)

    def run(make, vol):
        ix = make(vol)
        ix.index_batch(committed)
        ix.commit()
        ix.index_batch(acked)
        ix.delete([2, 17])
        return vol.crash()

    surv_t = run(lambda d: Indexer(cfg=tcfg, device="cpu", target_dir=d,
                                   wal=True), tdir.VolatileDirectory())
    surv_j = run(lambda d: DistributedIndexer(cfg=jcfg, target_dir=d,
                                              wal=True),
                 jdir.VolatileDirectory())
    _assert_same_files(surv_t, surv_j)
    ix_t = Indexer(cfg=tcfg, device="cpu", wal=True,
                   target_dir=_ram_copy(surv_t, tdir.RAMDirectory))
    ix_j = DistributedIndexer(cfg=jcfg, wal=True,
                              target_dir=_ram_copy(surv_t,
                                                   jdir.RAMDirectory))
    assert ix_t._wal.replayed == ix_j._wal.replayed == 2
    assert ix_t.refresh().n_docs == 24 - 2
    ix_j.refresh()
    _assert_same_live(ix_t.merger.live_segments(),
                      ix_j.merger.live_segments())
    assert ix_t._next_doc == ix_j._next_doc == 24
    ix_t.close()
    ix_j.close()


def test_faults_under_retry_policy_match_reference():
    """Seeded transient and torn faults under a retry policy: the same op
    sequence meets the same faults in both packages, the retries heal
    them alike, and the media underneath holds the same commit."""
    def run(pkg_dir, pkg_retry, make):
        fi = pkg_dir.FaultInjectingDirectory(
            pkg_dir.RAMDirectory(), seed=21, p_transient=0.15, p_torn=0.05,
            transient_repeat=2)
        ix = make(fi, pkg_retry.RetryPolicy(max_retries=3, **FAST))
        assert isinstance(ix.target_dir, pkg_retry.RetryingDirectory)
        rng = np.random.default_rng(14)
        for i in range(4):
            ix.index_batch(_tokens(rng))
            ix.delete([i * 16])
        ix.commit()
        ix.close()
        return fi, ix.target_dir.retries

    fi_t, retries_t = run(tdir, tretry, lambda d, p: Indexer(
        cfg=SMOKE, device="cpu", target_dir=d, wal=True, retry_policy=p))
    fi_j, retries_j = run(jdir, jretry, lambda d, p: DistributedIndexer(
        cfg=J_SMOKE, target_dir=d, wal=True, retry_policy=p))
    assert retries_t == retries_j > 0
    assert fi_t.injected == fi_j.injected
    _assert_same_files(fi_t.inner, fi_j.inner)
    gen, segs = tcommit.open_latest(fi_t.inner, device="cpu")
    assert sum(s.live_doc_count for s in segs) == 64 - 4


def test_scrubber_sweep_quarantines_like_reference():
    rng = np.random.default_rng(12)
    batches = [_tokens(rng) for _ in range(3)]
    rams = {}
    for name, make, ram in (
            ("t", lambda d: Indexer(cfg=SMOKE, device="cpu", target_dir=d),
             tdir.RAMDirectory()),
            ("j", lambda d: DistributedIndexer(cfg=J_SMOKE, target_dir=d),
             jdir.RAMDirectory())):
        ix = make(ram)
        for b in batches:
            ix.index_batch(b)
        ix.commit()
        ix.close()
        rams[name] = ram
    _assert_same_files(rams["t"], rams["j"])
    victim = sorted(n.split(".")[0] for n in rams["t"].list_files()
                    if n.endswith(".pst"))[1]
    found = {}
    for name, pkg_dir, pkg_commit, pkg_scrub, kw in (
            ("t", tdir, tcommit, tscrub, {"device": "cpu"}),
            ("j", jdir, jcommit, jscrub, {})):
        ram = rams[name]
        store, _ = pkg_commit.SegmentStore.open(ram, degraded=True, **kw)
        sc = pkg_scrub.ChecksumScrubber(ram, store=store)
        assert sc.sweep() == []
        pkg_dir.FaultInjectingDirectory(ram, seed=5).corrupt_file(
            victim + ".dict")
        hits = sc.sweep()
        rep = sc.report()
        # two sweeps read the manifest twice: its wall-clock stamp is the
        # one byte count that differs between the two runs
        rep["bytes_verified"] -= 2 * len(ram.read_file("segments_1"))
        found[name] = (hits, dict(store.quarantined), rep)
    assert found["t"] == found["j"]
    assert found["t"][0] == [victim + ".dict"]
    assert found["t"][1] == {victim: 16}
    gen_t, segs_t, info_t = tcommit.open_latest_degraded(rams["t"], "cpu")
    gen_j, segs_j, info_j = jcommit.open_latest_degraded(rams["j"])
    assert gen_t == gen_j and info_t.quarantined == info_j.quarantined
    assert info_t.missing_docs == info_j.missing_docs == 16
    _assert_same_live(segs_t, segs_j)


def test_scrubber_daemon_detects_rot_and_writer_self_heals():
    rng = np.random.default_rng(13)
    ram = tdir.RAMDirectory()
    ix = Indexer(cfg=SMOKE, device="cpu", target_dir=ram, scrub_every=0.01,
                 scrub_io_mbps=10_000.0)
    ix.index_batch(_tokens(rng))
    ix.index_batch(_tokens(rng))
    ix.commit()
    victim = sorted(n.split(".")[0] for n in ram.list_files()
                    if n.endswith(".pst"))[0]
    tdir.FaultInjectingDirectory(ram, seed=6).corrupt_file(victim + ".pos")
    scrubber = ix.scrubber
    try:
        for _ in range(1000):
            if ix.store.quarantined:
                break
            threading.Event().wait(0.01)
        assert ix.store.quarantined == {victim: 16}
        assert ix.refresh().degraded
    finally:
        scrubber._stop.set()
        scrubber._thread.join(timeout=30)
        assert not scrubber._thread.is_alive()
    ix.commit()                       # self-heal from memory
    assert ix.store.heals == 1
    ix.close()
    gen, segs = tcommit.open_latest(ram, device="cpu")
    assert sum(s.n_docs for s in segs) == 32


def test_kernel_failure_inside_recovery_propagates(monkeypatch):
    """``ctypes`` raises ``OSError`` when a kernel library fails to load.
    Recovery unpacks outside its ``try``, so such a failure fails
    recovery instead of skipping the commit or quarantining segments."""
    ram = tdir.RAMDirectory()
    ix = Indexer(cfg=SMOKE, device="cpu", target_dir=ram)
    ix.index_batch(_tokens(np.random.default_rng(1)))
    ix.commit()
    ix.close()

    def broken(*a, **k):
        raise OSError("libpostings_pack.so: cannot open shared object file")

    monkeypatch.setattr(tcodec.pack_ops, "unpack", broken)
    for call in (lambda: tcommit.open_latest(ram, device="cpu"),
                 lambda: tcommit.open_latest_degraded(ram, "cpu"),
                 lambda: tcommit.SegmentStore.open(ram, device="cpu"),
                 lambda: Indexer(cfg=SMOKE, device="cpu", target_dir=ram)):
        with pytest.raises(OSError, match="shared object"):
            call()
    assert ram.list_files().count("segments_1") == 1


def test_serve_index_dir_commits_recovers_and_serves(tmp_path):
    """``launch.serve --index-dir``: the first phase serves the searcher
    recovered from the commit, and the recovered final commit serves the
    indexer's live docs (the JAX package's flow prints the same lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--device", "cpu", "--requests", "8",
                     "--index-dir", str(tmp_path)])
    lines = out.getvalue().splitlines()
    assert lines[0] == ("durable index: commit gen 1 (0 docs recovered at "
                        f"startup); serving 128 docs recovered from "
                        f"{tmp_path}")
    assert lines[-1] == ("lifecycle durable: commit gen 2, 1 .liv delete "
                         "generation(s), recovery serves 248 live docs")
