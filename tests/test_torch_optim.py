"""Port parity for the optimizer substrate: ``repro_torch.optim.adamw``
(``update`` with clipping active and inactive, ``global_norm``,
``clip_by_global_norm``, ``cosine_schedule``) and
``repro_torch.optim.compress`` (int8 with error feedback) against the JAX
package's on the same numpy inputs, and the port's versions of
``tests/test_optim.py``'s four cases.

Tolerance: only the order of summation (the global norm's) and the
rounding of ``pow`` differ, so f32 results agree within ``F32_TOL``
(relative to each tensor's largest magnitude); the int8 codes agree
exactly where no value lies within an ulp of a rounding midpoint (none
does in these draws). ``update`` writes the params, m and v in place and
returns them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro_torch import tree as T
from repro_torch.convert import adamw_state_from_repro
from repro_torch.optim import adamw, compress

F32_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol=F32_TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _tree(rng, grad_scale):
    """params, grads and a nonzero AdamW state (numpy), shaped as a small
    LM's: a nested dict and a stacked leaf."""
    shapes = {"embed": (16, 8), "layers": {"w": (2, 8, 8),
                                           "ln": {"scale": (2, 8)}}}
    mk = lambda s: rng.normal(size=s).astype(np.float32)  # noqa
    params = jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree.map(lambda a: mk(a.shape) * grad_scale, params)
    m = jax.tree.map(lambda a: mk(a.shape) * 0.1, params)
    v = jax.tree.map(lambda a: np.abs(mk(a.shape)) * 0.01, params)
    return params, grads, m, v


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("grad_scale,clipped", [(10.0, True), (0.01, False)])
def test_update_matches_jax(grad_scale, clipped):
    rng = np.random.default_rng(0)
    params, grads, m, v = _tree(rng, grad_scale)
    jstate = JA.AdamWState(m=jax.tree.map(jnp.asarray, m),
                           v=jax.tree.map(jnp.asarray, v),
                           count=jnp.int32(3))
    jp, js, jm = JA.update(jax.tree.map(jnp.asarray, params),
                           jax.tree.map(jnp.asarray, grads), jstate,
                           lr=1e-2)
    assert (float(jm["grad_norm"]) > 1.0) == clipped
    tp = _t(params)
    state = adamw_state_from_repro(jstate)
    ids = [id(x) for x in T.leaves(tp) + T.leaves(state.m)
           + T.leaves(state.v)]
    got_p, got_s, om = adamw.update(tp, _t(grads), state, lr=1e-2)
    # in place: the very tensors passed in hold the new values
    assert [id(x) for x in T.leaves(got_p) + T.leaves(got_s.m)
            + T.leaves(got_s.v)] == ids
    assert got_p is tp and int(got_s.count) == int(js.count) == 4
    assert got_s.count.dtype == torch.int32
    _close(om["grad_norm"], jm["grad_norm"])
    for got, want in ((got_p, jp), (got_s.m, js.m), (got_s.v, js.v)):
        for a, b in zip(T.leaves(got), jax.tree.leaves(want)):
            _close(a, b)


def test_clip_and_norm_match_jax():
    rng = np.random.default_rng(1)
    _, grads, _, _ = _tree(rng, 5.0)
    jc, jn = JA.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    tc, tn = adamw.clip_by_global_norm(_t(grads), 1.0)
    _close(tn, jn)
    _close(adamw.global_norm(_t(grads)), JA.global_norm(grads))
    for a, b in zip(T.leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 140])
def test_cosine_schedule_matches_jax(step):
    """Warm-up (0, 5), its end (10), mid-decay (55), the end (100) and
    past it (140)."""
    want = float(JA.cosine_schedule(1e-3, warmup=10, total=100)(step))
    got = adamw.cosine_schedule(1e-3, warmup=10, total=100)(step)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= F32_TOL * 1e-3


def test_int8_compression_matches_jax():
    """Three steps of compression with error feedback: codes, scales,
    residuals and the decompressed grads equal the JAX package's."""
    rng = np.random.default_rng(2)
    seq = [{"w": rng.normal(size=(64,)).astype(np.float32) * s,
            "b": {"c": rng.normal(size=(4, 4)).astype(np.float32)}}
           for s in (0.5, 3.0, 0.01)]
    jerr = JC.init_error_state(jax.tree.map(jnp.asarray, seq[0]))
    terr = compress.init_error_state(_t(seq[0]))
    for g in seq:
        jcomp, jerr = JC.compress_grads(jax.tree.map(jnp.asarray, g), jerr)
        tcomp, terr = compress.compress_grads(_t(g), terr)
        jl = jax.tree.leaves(jcomp)
        tl = T.leaves(tcomp)
        assert len(jl) == len(tl) == 4
        for a, b in zip(tl, jl):
            if b.dtype == jnp.int8:
                assert a.dtype == torch.int8
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                _close(a, b)
        for a, b in zip(T.leaves(terr), jax.tree.leaves(jerr)):
            _close(a, b)
        jd = JC.decompress_grads(jcomp)
        td = compress.decompress_grads(tcomp)
        for a, b in zip(T.leaves(td), jax.tree.leaves(jd)):
            _close(a, b)
    assert compress.compressed_bytes(tcomp) == JC.compressed_bytes(jcomp)


# --------------------------------------------------------------------------
# tests/test_optim.py's cases on the port
# --------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"x": torch.zeros(3)}
    opt = adamw.init(params)
    for _ in range(400):
        g = {"x": 2 * (params["x"] - target)}
        params, opt, _ = adamw.update(params, g, opt, lr=3e-2,
                                      weight_decay=0.0)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(),
                               atol=1e-2)


def test_grad_clipping():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(norm) > 100
    np.testing.assert_allclose(float(adamw.global_norm(clipped)), 1.0,
                               rtol=1e-5)


def test_cosine_schedule():
    lr = adamw.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    np.testing.assert_allclose(float(lr(10)), 1e-3, rtol=1e-5)
    assert float(lr(100)) < 1e-5


def test_int8_compression_error_feedback():
    """With error feedback the accumulated compressed sum converges to the
    accumulated true sum (residuals don't build up)."""
    rng = np.random.default_rng(0)
    grads_seq = [{"w": torch.from_numpy(rng.normal(size=(64,)) *
                                        rng.uniform(0.1, 5)).float()}
                 for _ in range(50)]
    err = compress.init_error_state(grads_seq[0])
    acc_true = np.zeros(64)
    acc_comp = np.zeros(64)
    for g in grads_seq:
        comp, err = compress.compress_grads(g, err)
        deq = compress.decompress_grads(comp)
        acc_true += g["w"].numpy()
        acc_comp += deq["w"].numpy()
    denom = np.abs(acc_true).mean()
    assert np.abs(acc_comp - acc_true).mean() / denom < 0.05
    assert compress.compressed_bytes(comp) < 64 * 4 / 3
