"""The port's slice end to end on the CPU: ``repro_torch.launch.serve``'s
retrieval flow (index, refresh, serve, index more, refresh, serve, delete
+ update, refresh, serve) against the JAX package's own flow
(``DistributedIndexer`` + ``QueryScheduler`` via ``repro.launch.serve``)
on the same corpus batches and queries: equal scores, bit for bit, and
equal doc ids in every phase it reports; and the device rule of the
port's entry points."""
import contextlib
import io
import re

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.configs.lucene_envelope import SMOKE
from repro_torch.core.indexer import Indexer
from repro_torch.core.searcher import IndexSearcher, ReaderCache
from repro_torch.launch import serve as tserve
from repro_torch.serving.query_scheduler import QueryScheduler


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _untimed(text: str) -> list:
    """Printed lines minus their timings (which differ run to run)."""
    out = []
    for line in text.splitlines():
        line = re.sub(r"in \d+ms \(\d+ qps.*?\)", "", line)
        line = re.sub(r"refresh: [\d.]+ms", "refresh:", line)
        out.append(line)
    return out


@pytest.mark.parametrize("requests", [4, 48])
def test_serve_flow_matches_jax(requests):
    argv = ["--requests", str(requests), "--deletes", "8", "--updates", "4"]
    j_out, t_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(j_out):
        j_done = jserve.main(["--mode", "retrieval", *argv])
    with contextlib.redirect_stdout(t_out):
        phases, report = tserve.main(["--device", "cpu", *argv])
    j_lines, t_lines = _untimed(j_out.getvalue()), _untimed(t_out.getvalue())
    midgrid = [ln for ln in t_lines if ln.startswith("midgrid:")]
    assert len(midgrid) == 1
    t_lines.remove(midgrid[0])
    assert t_lines == j_lines
    t_done = phases["lifecycle"][1]
    assert len(t_done) == len(j_done) == min(requests, 32)
    for jr, tr in zip(j_done, t_done):
        assert jr.rid == tr.rid
        np.testing.assert_array_equal(np.asarray(tr.terms),
                                      np.asarray(jr.terms))
        np.testing.assert_array_equal(
            np.asarray(tr.scores, np.float32).view(np.uint32),
            np.asarray(jr.scores, np.float32).view(np.uint32))
        np.testing.assert_array_equal(np.asarray(tr.doc_ids, np.int64),
                                      np.asarray(jr.doc_ids, np.int64))
    assert report["deleted"] == 8 and report["updated"] == 4
    assert report["serve1_queries"] == requests


def test_entry_points_need_cuda_or_explicit_cpu():
    """Without a CUDA device every entry point raises unless the caller
    passes device="cpu"; it never carries on quietly on the host."""
    if torch.cuda.is_available():
        assert Indexer(cfg=SMOKE).device.type == "cuda"
        return
    for make in (lambda: Indexer(cfg=SMOKE), lambda: ReaderCache(),
                 lambda: IndexSearcher(readers=[]),
                 lambda: QueryScheduler(searcher=None),
                 lambda: tserve.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert Indexer(cfg=SMOKE, device="cpu").device.type == "cpu"
    assert ReaderCache(device="cpu").refresh([]).device.type == "cpu"


def test_later_slices_raise_not_implemented():
    for kw in ({"mesh": object()}, {"refresh_every": 1.0},
               {"merge_threads": 2}, {"publisher": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Indexer(cfg=SMOKE, device="cpu", **kw)
    ix = Indexer(cfg=SMOKE, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ix.envelope_report()
