"""The port's term shuffle and multi-device indexing step
(``repro_torch.core.shuffle``, ``core.indexer.make_index_step``) against
the JAX package's, bit for bit, on the CPU.

The JAX side runs once per module, in a subprocess that sees 8 virtual
host devices (``--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs it), and writes every device's
outputs to an ``.npz``. The port runs every rank of the same mesh in
this process (``index_step_loopback``; for the shuffle alone the send
and receive stages with the buffers moved between ranks by hand); the
real collective path over 4 processes is ``test_torch_mesh_procs.py``.

Inputs are made with numpy from fixed seeds and saved by the subprocess,
so both sides see the same bytes."""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.lucene_envelope import SMOKE
from repro_torch.core import shuffle as tshuffle
from repro_torch.core.indexer import index_step_loopback, make_index_step
from repro_torch.core.invert import TERM_PAD, InvertedRun
from repro_torch.distributed import Mesh

REPO = Path(__file__).resolve().parents[1]
N_DEV = 8
D_PER, L, V = 16, 32, 97        # invert_and_shuffle: 8 ranks x 16 docs
DROP_CAP = 40                   # route_entries: a capacity that drops
COMBOS = [("raw", False), ("raw", True), ("packed2", False),
          ("packed2", True)]

JAX_SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.configs.registry import get_arch
from repro.core.indexer import make_index_step
from repro.core.shuffle import invert_and_shuffle, route_entries
from repro.distributed.compat import shard_map

D_PER, L, V, CAP = {D_PER}, {L}, {V}, {DROP_CAP}
out = {{}}
rng = np.random.default_rng(7)
tokens = rng.integers(0, V, size=(8 * D_PER, L)).astype(np.int32)
tokens[:, L - 5:] = 0                       # trailing padding too
out["tokens"] = tokens
mesh = jax.make_mesh((8,), ("model",))

def per_device(fn, toks):
    def local(t):
        return jax.tree.map(lambda x: x[None] if x.ndim == 0 else x, fn(t))
    return jax.jit(shard_map(local, mesh=mesh, in_specs=P("model", None),
                             out_specs=P("model"),
                             check_vma=False))(jnp.asarray(toks))

for payload, sk in {COMBOS}:
    def fn(t, payload=payload, sk=sk):
        idx = lax.axis_index("model")
        return invert_and_shuffle(t, idx * D_PER, axis_name="model",
                                  n_dest=8, payload=payload,
                                  single_key_sort=sk)
    run, stats = per_device(fn, tokens)
    for f in run._fields:
        out[f"isf_{{payload}}_{{sk}}_{{f}}"] = np.asarray(getattr(run, f))
    for f in stats._fields:
        out[f"isf_{{payload}}_{{sk}}_{{f}}"] = np.asarray(getattr(stats, f))

# skewed terms (about half are multiples of 8) overflow destination 0
skew = rng.integers(1, V, size=(8 * D_PER, L)).astype(np.int32)
skew[rng.random(skew.shape) < 0.5] = 8 * rng.integers(1, 12)
out["skew"] = skew
for payload in ("raw", "packed2"):
    def fn(t, payload=payload):
        idx = lax.axis_index("model")
        D = t.shape[0]
        term = t.reshape(-1)
        doc = (jnp.arange(D, dtype=jnp.int32)[:, None]
               + idx * D_PER).repeat(L, 1).reshape(-1)
        pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None],
                               (D, L)).reshape(-1)
        st, sd, sp = lax.sort((term, doc, pos), num_keys=3)
        return route_entries(st, sd, sp, axis_name="model", n_dest=8,
                             capacity=CAP, payload=payload,
                             doc_base=idx * D_PER, docs_per_dev=D_PER)
    (rt, rd, rp), stats = per_device(fn, skew)
    for f, v in zip(("term", "doc", "pos"), (rt, rd, rp)):
        out[f"route_{{payload}}_{{f}}"] = np.asarray(v)
    for f in stats._fields:
        out[f"route_{{payload}}_{{f}}"] = np.asarray(getattr(stats, f))

cfg0 = get_arch("lucene-envelope").smoke
mesh24 = jax.make_mesh((2, 4), ("data", "model"))
rng = np.random.default_rng(11)
step_tokens = rng.integers(1, 1 << cfg0.vocab_bits,
                           size=(8 * cfg0.docs_per_shard, cfg0.doc_len)
                           ).astype(np.int32)
lens = rng.integers(1, cfg0.doc_len + 1, size=step_tokens.shape[0])
step_tokens[np.arange(cfg0.doc_len)[None, :] >= lens[:, None]] = 0
out["step_tokens"] = step_tokens
for payload in ("raw", "packed2"):
    cfg = dataclasses.replace(cfg0, shuffle_payload=payload)
    step = make_index_step(cfg, mesh24, doc_len=cfg.doc_len)
    with mesh24:
        res = jax.jit(step)(jnp.asarray(step_tokens))
    for f in res["run"]._fields:
        out[f"step_{{payload}}_run_{{f}}"] = np.asarray(getattr(res["run"], f))
    for f in res["stats"]._fields:
        out[f"step_{{payload}}_stats_{{f}}"] = np.asarray(
            getattr(res["stats"], f))
    for key in ("packed_docs", "bw_docs", "packed_pos", "bw_pos",
                "packed_bytes"):
        out[f"step_{{payload}}_{{key}}"] = np.asarray(res[key])
np.savez(sys.argv[1], **out)
print("JAX-SHUFFLE-OK")
""".format(D_PER=D_PER, L=L, V=V, DROP_CAP=DROP_CAP, COMBOS=COMBOS)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """Every device's outputs of the JAX functions, from one subprocess
    with 8 virtual host devices."""
    path = tmp_path_factory.mktemp("jax_shuffle") / "out.npz"
    env_code = ("import os\nos.environ['XLA_FLAGS'] = "
                "'--xla_force_host_platform_device_count=8'\n")
    r = subprocess.run(
        [sys.executable, "-c", env_code + textwrap.dedent(JAX_SCRIPT),
         str(path)], capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(path.parent), "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "JAX-SHUFFLE-OK" in r.stdout
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _per_device(a: np.ndarray, dev: int) -> np.ndarray:
    """Device ``dev``'s slice of a JAX output concatenated over devices."""
    n = a.shape[0] // N_DEV
    return a[dev * n:(dev + 1) * n]


def _same(name: str, port: torch.Tensor, want: np.ndarray) -> None:
    got = port.detach().cpu().numpy()
    if got.ndim == 0:
        got = got[None]
    assert got.dtype.itemsize == want.dtype.itemsize, (name, got.dtype,
                                                       want.dtype)
    np.testing.assert_array_equal(got.view(want.dtype).reshape(want.shape),
                                  want, err_msg=name)


def _loopback_shuffle(tokens, payload, sk, n=N_DEV):
    """``invert_and_shuffle`` on every rank of an (n,) ``model`` mesh in
    this process: the send stages, the buffers' rows moved between ranks
    as the all-to-all moves them, the receive stages."""
    sends = [tshuffle.shuffle_send(torch.from_numpy(tokens[r * D_PER:
                                                           (r + 1) * D_PER]),
                                   r * D_PER, n_dest=n, payload=payload,
                                   single_key_sort=sk) for r in range(n)]
    outs = []
    for m, sent in enumerate(sends):
        received = tuple(torch.stack([s.buffers[i][m] for s in sends])
                         for i in range(len(sent.buffers)))
        outs.append(tshuffle.shuffle_receive(sent, received, m))
    return outs


@pytest.mark.parametrize("payload,sk", COMBOS)
def test_invert_and_shuffle_matches_jax(jax_out, payload, sk):
    outs = _loopback_shuffle(jax_out["tokens"], payload, sk)
    for dev, (run, stats) in enumerate(outs):
        for f in InvertedRun._fields:
            _same(f"{f} dev {dev}", getattr(run, f), _per_device(
                jax_out[f"isf_{payload}_{sk}_{f}"], dev))
        for f in tshuffle.ShuffleStats._fields:
            _same(f"{f} dev {dev}", getattr(stats, f), _per_device(
                jax_out[f"isf_{payload}_{sk}_{f}"], dev))


@pytest.mark.parametrize("payload,sk", COMBOS)
def test_shuffle_conservation_and_ownership(jax_out, payload, sk):
    """As ``tests/test_distributed.py`` holds the JAX shuffle: nothing
    dropped at the 1.35 factor, every valid token sent and received once,
    and every term on rank m is m mod 8."""
    tokens = jax_out["tokens"]
    outs = _loopback_shuffle(tokens, payload, sk)
    assert sum(int(s.dropped) for _, s in outs) == 0
    assert sum(int(s.sent) for _, s in outs) == (tokens > 0).sum()
    assert sum(int(s.recv) for _, s in outs) == (tokens > 0).sum()
    for m, (run, _) in enumerate(outs):
        terms = run.terms_unique[:int(run.n_terms)]
        assert bool((terms % N_DEV == m).all()), m


def _sorted_entries(block: np.ndarray, base: int):
    D = block.shape[0]
    term = torch.from_numpy(block).reshape(-1)
    doc = (torch.arange(D, dtype=torch.int32)[:, None] + base).expand(
        D, L).reshape(-1)
    pos = torch.arange(L, dtype=torch.int32).expand(D, L).reshape(-1)
    order = torch.sort(term, stable=True).indices
    return term[order], doc[order], pos[order]


@pytest.mark.parametrize("payload", ["raw", "packed2"])
def test_route_entries_drops_what_jax_drops(jax_out, payload):
    """At a capacity of 40 entries a destination, the skewed input
    overflows: the port drops the same entries and keeps the same."""
    skew = jax_out["skew"]
    sends = []
    for r in range(N_DEV):
        st, sd, sp = _sorted_entries(skew[r * D_PER:(r + 1) * D_PER],
                                     r * D_PER)
        sends.append(tshuffle.route_send(st, sd, sp, n_dest=N_DEV,
                                         capacity=DROP_CAP, payload=payload,
                                         doc_base=r * D_PER))
    dropped = 0
    for m, (bufs, sent, drop) in enumerate(sends):
        received = tuple(torch.stack([s[0][i][m] for s in sends])
                         for i in range(len(bufs)))
        (rt, rd, rp), recv = tshuffle.route_receive(
            received, payload=payload, axis_index=m, doc_base=m * D_PER,
            docs_per_dev=D_PER)
        for f, got in (("term", rt), ("doc", rd), ("pos", rp),
                       ("sent", sent), ("dropped", drop), ("recv", recv)):
            _same(f"{f} dev {m}", got, _per_device(
                jax_out[f"route_{payload}_{f}"], m))
        dropped += int(drop)
    assert dropped > 0


@pytest.mark.parametrize("payload", ["raw", "packed2"])
def test_index_step_on_a_2x4_mesh_matches_jax(jax_out, payload):
    cfg = dataclasses.replace(SMOKE, shuffle_payload=payload)
    tokens = jax_out["step_tokens"]
    D = cfg.docs_per_shard
    outs = index_step_loopback(cfg, {"data": 2, "model": 4},
                               [tokens[r * D:(r + 1) * D]
                                for r in range(N_DEV)], cfg.doc_len)
    for dev, out in enumerate(outs):
        for f in InvertedRun._fields:
            _same(f"run.{f} dev {dev}", getattr(out["run"], f), _per_device(
                jax_out[f"step_{payload}_run_{f}"], dev))
        for f in tshuffle.ShuffleStats._fields:
            _same(f"stats.{f} dev {dev}", getattr(out["stats"], f),
                  _per_device(jax_out[f"step_{payload}_stats_{f}"], dev))
        for key in ("packed_docs", "bw_docs", "packed_pos", "bw_pos"):
            _same(f"{key} dev {dev}", out[key], _per_device(
                jax_out[f"step_{payload}_{key}"], dev))
        want = _per_device(jax_out[f"step_{payload}_packed_bytes"], dev)
        assert out["packed_bytes"] == float(want[0]) > 0


def test_index_step_packed2_equals_raw(jax_out):
    """The optimized payload (packed2 + single-key sort) gives the raw
    3-word path's outputs bit for bit, on every rank."""
    tokens = jax_out["step_tokens"]
    D = SMOKE.docs_per_shard
    blocks = [tokens[r * D:(r + 1) * D] for r in range(N_DEV)]
    outs = {p: index_step_loopback(
        dataclasses.replace(SMOKE, shuffle_payload=p),
        {"data": 2, "model": 4}, blocks, SMOKE.doc_len)
        for p in ("raw", "packed2")}
    for raw, p2 in zip(outs["raw"], outs["packed2"]):
        for f in InvertedRun._fields:
            assert torch.equal(getattr(raw["run"], f),
                               getattr(p2["run"], f)), f
        for key in ("packed_docs", "bw_docs", "packed_pos", "bw_pos"):
            assert torch.equal(raw[key], p2[key]), key


def test_packed2_reads_local_docs_past_the_sign_bit():
    """A local doc index >= 32768 sets bit 31 of the packed2 word; the
    receiver must shift it back logically. Two ranks exchange entries of
    local docs near 65535, raw and packed2 alike."""
    n, D = 2, 65536
    rng = np.random.default_rng(3)
    sends = {"raw": [], "packed2": []}
    for r in range(n):
        local = np.sort(rng.choice(np.arange(30000, D), 64, replace=False))
        term = torch.from_numpy(rng.integers(1, 9, 64).astype(np.int32))
        doc = torch.from_numpy((local + r * D).astype(np.int32))
        pos = torch.from_numpy(rng.integers(0, 65536, 64).astype(np.int32))
        order = torch.sort(term, stable=True).indices
        for payload in sends:
            sends[payload].append(tshuffle.route_send(
                term[order], doc[order], pos[order], n_dest=n, capacity=128,
                payload=payload, doc_base=r * D))
    got = {}
    for payload, per_rank in sends.items():
        got[payload] = []
        for m in range(n):
            received = tuple(torch.stack([s[0][i][m] for s in per_rank])
                             for i in range(len(per_rank[m][0])))
            got[payload].append(tshuffle.route_receive(
                received, payload=payload, axis_index=m, doc_base=m * D,
                docs_per_dev=D))
    for (raw, c1), (p2, c2) in zip(got["raw"], got["packed2"]):
        assert int(c1) == int(c2) > 0
        for a, b in zip(raw, p2):
            assert torch.equal(a, b)
        assert int(raw[1].max()) >= 32768


@pytest.mark.parametrize("D,L_,n", [(4096, 1024, 1), (4096, 1024, 2),
                                    (16, 32, 8), (32, 64, 4), (7, 3, 5)])
def test_capacity_is_the_jax_arithmetic(D, L_, n):
    cap = int(D * L_ * 1.35 / n)
    want = max((cap + 127) // 128 * 128, 128)
    assert tshuffle.shuffle_capacity(D, L_, n) == want
    assert want % 128 == 0


def test_step_checks_its_mesh_payload_and_device():
    mesh = Mesh({"data": 1, "model": 1}, 0)
    with pytest.raises(TypeError, match="Mesh"):
        make_index_step(SMOKE, object(), SMOKE.doc_len, device="cpu")
    with pytest.raises(ValueError, match="no axis 'model'"):
        make_index_step(SMOKE, Mesh({"shard": 2}, 0), SMOKE.doc_len,
                        device="cpu")
    bad = dataclasses.replace(SMOKE, shuffle_payload="packed3")
    with pytest.raises(ValueError, match="payload"):
        make_index_step(bad, mesh, SMOKE.doc_len, device="cpu").send(
            np.ones((4, SMOKE.doc_len), np.int32))
    with pytest.raises(ValueError, match="tokens must be"):
        make_index_step(SMOKE, mesh, SMOKE.doc_len, device="cpu").send(
            np.ones((4, 3), np.int32))
    # a mesh without process groups answers coordinates, not collectives
    with pytest.raises(RuntimeError, match="no process group"):
        make_index_step(SMOKE, mesh, SMOKE.doc_len, device="cpu")(
            np.ones((4, SMOKE.doc_len), np.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_index_step(SMOKE, mesh, SMOKE.doc_len)


@pytest.mark.parametrize("shape", [{"data": 2, "model": 4},
                                   {"pod": 2, "data": 3, "model": 2},
                                   {"shard": 4}])
def test_mesh_coordinates_are_row_major(shape):
    """A rank's flat index over every axis is its rank (the JAX
    package's ``_flat_device_index``), and its line along an axis holds
    the ranks that differ from it on that axis alone, by index."""
    size = int(np.prod(list(shape.values())))
    grid = np.arange(size).reshape(tuple(shape.values()))
    for r in range(size):
        m = Mesh(shape, r)
        assert m.flat_index() == r
        at = np.argwhere(grid == r)[0]
        for ax, name in enumerate(shape):
            assert m.axis_index(name) == at[ax]
            line = [int(grid[tuple(np.r_[at[:ax], [i], at[ax + 1:]])])
                    for i in range(shape[name])]
            assert m.axis_ranks(name) == line
    with pytest.raises(ValueError):
        Mesh(shape, size)


def test_term_pad_sinks_padding():
    sent = tshuffle.shuffle_send(torch.zeros((2, 4), dtype=torch.int32), 0,
                                 n_dest=2)
    assert int(sent.sent) == 0
    (rt, rd, rp), recv = tshuffle.route_receive(
        tuple(torch.stack([b[m] for m in range(2)]) for b in sent.buffers))
    assert int(recv) == 0 and bool((rt == TERM_PAD).all())
    assert not rd.any() and not rp.any()
