"""The port's examples (``examples/torch_*.py``) with ``--device cpu``
against the JAX package's (``examples/*.py``; the fleet demo's lags and
rates taken out), and the port's serving CLI
with the NRT refresh daemon (``--refresh-every``) against the JAX CLI's:
printed lines equal once timings are taken out. Of
``examples/serve_retrieval.py`` only the lexical lines count (its dense
two-tower half is not ported). With the daemon running, a refresh's
reader builds and cache hits count the daemon's ticks, which follow the
clock: they are taken out with the timings."""
import contextlib
import io
import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _untimed(text: str, daemon: bool = False) -> list:
    out = []
    for line in text.splitlines():
        line = re.sub(r"in \d+ms \(\d+ qps[^)]*\)", "", line)
        line = re.sub(r"refresh \([\d.]+ms, ", "refresh (", line)
        line = re.sub(r"refresh: [\d.]+ms", "refresh:", line)
        line = re.sub(r"np\.(int|float)\d+\(([^)]*)\)", r"\2", line)
        if daemon:
            line = re.sub(r"reader builds \d+ \(cache hits \d+\)",
                          "reader builds", line)
        out.append(line)
    return out


def _run(path: Path, argv=()) -> str:
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [str(path), *argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue()


@pytest.mark.parametrize("name", ["quickstart", "index_corpus",
                                  "serve_retrieval"])
def test_example_matches_jax(name):
    want = _untimed(_run(EXAMPLES / f"{name}.py"))
    got = _untimed(_run(EXAMPLES / f"torch_{name}.py", ["--device", "cpu"]))
    if name == "serve_retrieval":
        dense = [ln for ln in want if ln.startswith(("dense:", "hybrid"))]
        assert len(dense) == 2
        want = [ln for ln in want if ln not in dense]
    assert got == want
    assert len(got) >= 3


def _fleet_untimed(text: str) -> list:
    """The fleet demo's lines without its replication lags, rates and
    heal time."""
    out = []
    for line in text.splitlines():
        line = re.sub(r"=\d+ms", "=", line)
        line = re.sub(r"\d+ qps", "qps", line)
        line = re.sub(r"in \d+ms", "in", line)
        out.append(line)
    return out


def test_serve_fleet_example_matches_jax():
    """``examples/torch_serve_fleet.py --device cpu`` (4 replica processes
    on the CPU) prints what ``examples/serve_fleet.py`` prints: the
    bytes each replica pulled, every batch exact against the union
    oracle, the ledger's bytes, the rotted file and the repair count."""
    want = _fleet_untimed(_run(EXAMPLES / "serve_fleet.py"))
    got = _fleet_untimed(_run(EXAMPLES / "torch_serve_fleet.py",
                              ["--device", "cpu"]))
    assert got == want
    assert got[-1] == "fleet serving demo OK" and len(got) == 11


def test_example_needs_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(EXAMPLES / "torch_quickstart.py")


def test_serve_cli_with_refresh_daemon_matches_jax():
    argv = ["--refresh-every", "0.05", "--requests", "8", "--deletes", "8",
            "--updates", "4"]
    j_out, t_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(j_out):
        j_done = jserve.main(["--mode", "retrieval", *argv])
    with contextlib.redirect_stdout(t_out):
        phases, report = tserve.main(["--device", "cpu", *argv])
    j_lines = _untimed(j_out.getvalue(), daemon=True)
    t_lines = _untimed(t_out.getvalue(), daemon=True)
    t_lines = [ln for ln in t_lines if not ln.startswith("midgrid:")]
    assert t_lines == j_lines
    assert any(ln.startswith("lifecycle:") for ln in t_lines)
    assert len(phases["lifecycle"][1]) == len(j_done) == 8
    assert report["deleted"] == 8 and report["updated"] == 4
