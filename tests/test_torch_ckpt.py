"""The port's checkpointing (``repro_torch.checkpoint.ckpt``) and LM data
pipeline (``repro_torch.data.lm``): the port's versions of
``tests/test_checkpoint.py``'s roundtrip, crash, keep-k, async and
bitwise-resume cases (bitwise on the CPU); ``save_async`` not torn by an
in-place update made right after it returns (and torn without its host
copy, the planted fault); a mesh (``shardings=``) raising; a checkpoint
of a JAX tree carried over by ``convert`` restoring it exactly;
``LMBatches.batch_at`` equal to the JAX package's bit for bit; and
``Prefetcher.get`` raising what its worker died of."""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.lm import LMBatches as JaxBatches
from repro.optim import adamw as JA
from repro_torch import tree as T
from repro_torch.checkpoint import ckpt
from repro_torch.convert import adamw_state_from_repro, lm_params_from_repro
from repro_torch.data.lm import LMBatches, Prefetcher
from repro_torch.optim import adamw


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "h": torch.randn((3,), generator=g).to(
                           torch.bfloat16)},
            "scalar": torch.tensor(3.5)}


def _equal(a, b):
    for x, y in zip(T.leaves(a), T.leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    tree = make_tree()
    ckpt.save(tmp_path, 7, tree)
    restored, step = ckpt.restore(tmp_path, tree)
    assert step == 7
    _equal(tree, restored)
    man = json.loads((tmp_path / "step_000000007" / "manifest.json")
                     .read_text())
    assert man["dtypes"] == ["int32", "bfloat16", "float32", "float32"]


def test_crash_leaves_no_corrupt_checkpoint(tmp_path):
    tree = make_tree()
    ckpt.save(tmp_path, 1, tree)
    tmp = tmp_path / "step_000000002.tmp"
    tmp.mkdir()
    (tmp / "arrays.npz").write_bytes(b"garbage")
    assert ckpt.latest_step(tmp_path) == 1  # .tmp is not visible
    _, step = ckpt.restore(tmp_path, tree)
    assert step == 1


def test_keep_k_gc(tmp_path):
    tree = make_tree()
    for s in range(6):
        ckpt.save(tmp_path, s, tree, keep_k=3)
    steps = sorted(p.name for p in tmp_path.iterdir())
    assert len(steps) == 3 and steps[-1] == "step_000000005"


def test_async_checkpointer(tmp_path):
    tree = make_tree()
    acp = ckpt.AsyncCheckpointer(tmp_path)
    for s in range(3):
        acp.save_async(s, T.tree_map(lambda x: x + s, tree))
    acp.wait()
    restored, step = ckpt.restore(tmp_path, tree)
    assert step == 2
    assert float(restored["scalar"]) == 5.5


def _held_writer(monkeypatch):
    """Make the checkpoint writer wait for ``go`` before it reads the
    tree: the update after ``save_async`` then surely comes first."""
    go = threading.Event()
    orig = ckpt.save

    def held(*a, **kw):
        assert go.wait(30)
        return orig(*a, **kw)
    monkeypatch.setattr(ckpt, "save", held)
    return go


@pytest.mark.parametrize("fault", [False, True])
def test_save_async_is_not_torn_by_an_in_place_update(tmp_path,
                                                      monkeypatch, fault):
    """The port's AdamW writes the params in place right after a save:
    the saved step holds the values at ``save_async``'s return. Without
    the host copy (the planted fault) the writer reads the updated
    values."""
    if fault:
        monkeypatch.setattr(ckpt, "host_copy", lambda tree: tree)
    go = _held_writer(monkeypatch)
    params = {"w": torch.randn(64, 64)}
    opt = adamw.init(params)
    want = T.tree_map(torch.clone, {"params": params, "opt": opt})
    acp = ckpt.AsyncCheckpointer(tmp_path)
    acp.save_async(0, {"params": params, "opt": opt})
    adamw.update(params, {"w": torch.ones(64, 64)}, opt, lr=1e-2)
    go.set()
    acp.wait()
    got, _ = ckpt.restore(tmp_path, want)
    torn = not all(torch.equal(a, b) for a, b in zip(T.leaves(got),
                                                     T.leaves(want)))
    assert torn == fault


def test_writer_error_is_raised_by_wait(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt, "save", broken)
    acp = ckpt.AsyncCheckpointer(tmp_path)
    acp.save_async(0, make_tree())
    with pytest.raises(OSError, match="disk full"):
        acp.wait()
    acp.wait()  # raised once


def test_restore_onto_a_mesh_raises(tmp_path):
    tree = make_tree()
    ckpt.save(tmp_path, 3, tree)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ckpt.restore(tmp_path, tree, shardings=object())


def test_jax_params_and_state_roundtrip_exactly(tmp_path):
    """A JAX parameter tree and AdamW state carried over by ``convert``
    save and restore into ``{"params", "opt"}`` bit for bit, leaves in
    ``jax.tree_util``'s order."""
    jp = {"embed": jax.random.normal(jax.random.PRNGKey(0), (6, 4)),
          "layers": {"wq": jnp.ones((2, 4, 4)) * 0.5,
                     "ln1": {"scale": jnp.zeros((2, 4))}}}
    js = JA.init(jp)._replace(count=jnp.int32(7))
    tree = {"params": lm_params_from_repro(jp),
            "opt": adamw_state_from_repro(js)}
    assert [tuple(x.shape) for x in T.leaves(tree)] == [
        tuple(x.shape) for x in jax.tree.leaves({"params": jp, "opt": js})]
    ckpt.save(tmp_path, 1, tree)
    got, _ = ckpt.restore(tmp_path, tree)
    _equal(tree, got)
    assert isinstance(got["opt"], adamw.AdamWState)
    assert int(got["opt"].count) == 7


def test_training_resume_is_bitwise(tmp_path):
    """Kill-and-restart: the resumed run reproduces the uninterrupted run
    bit for bit (on the CPU)."""
    data = LMBatches(vocab_size=64, batch=4, seq_len=8, seed=42)
    params = {"w": torch.randn((64, 64),
                               generator=torch.Generator().manual_seed(0))
              * 0.1}

    def step_fn(p, opt, batch):
        w = p["w"].detach().requires_grad_(True)
        x = w[torch.from_numpy(batch["tokens"]).reshape(-1).long()]
        logits = x @ w.T
        t = torch.from_numpy(batch["targets"]).reshape(-1).long()
        loss = -torch.log_softmax(logits, -1)[torch.arange(len(t)), t].mean()
        (g,) = torch.autograd.grad(loss, [w])
        p, opt, _ = adamw.update(p, {"w": g}, opt, lr=1e-2)
        return p, opt

    def run(p, opt, start, end, ckdir=None):
        for s in range(start, end):
            p, opt = step_fn(p, opt, data.batch_at(s))
            if ckdir is not None:
                ckpt.save(ckdir, s, {"params": p, "opt": opt})
        return p, opt

    fresh = lambda: T.tree_map(torch.clone, params)  # noqa
    p0 = fresh()
    pA, _ = run(p0, adamw.init(p0), 0, 8)
    p1 = fresh()
    run(p1, adamw.init(p1), 0, 5, ckdir=tmp_path)
    like = {"params": fresh(), "opt": adamw.init(fresh())}
    state, last = ckpt.restore(tmp_path, like)
    assert last == 4
    pB, _ = run(state["params"], state["opt"], 5, 8)
    assert torch.equal(pA["w"], pB["w"])


# --------------------------------------------------------------------------
# the LM data pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 17])
def test_lm_batches_equal_the_jax_packages(step):
    want = JaxBatches(vocab_size=1000, batch=3, seq_len=33,
                      seed=5).batch_at(step)
    got = LMBatches(vocab_size=1000, batch=3, seq_len=33,
                    seed=5).batch_at(step)
    assert set(got) == set(want) == {"tokens", "targets", "mask"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_serves_steps_in_order():
    data = LMBatches(vocab_size=50, batch=2, seq_len=4, seed=1)
    pf = Prefetcher(data.batch_at, start_step=3)
    try:
        for s in range(3, 7):
            step, b = pf.get()
            assert step == s
            np.testing.assert_array_equal(b["tokens"],
                                          data.batch_at(s)["tokens"])
    finally:
        pf.close()


def test_prefetcher_get_raises_what_its_worker_died_of():
    def batch_fn(step):
        if step == 2:
            raise ValueError("bad shard 2")
        return {"step": step}
    pf = Prefetcher(batch_fn)
    try:
        assert pf.get()[0] == 0 and pf.get()[0] == 1
        for _ in range(2):  # and again on a later call
            with pytest.raises(ValueError, match="bad shard 2"):
                pf.get()
    finally:
        pf.close()
