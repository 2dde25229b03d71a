"""Port parity for the LM training path: ``layers.chunked_softmax_xent``
and the train attention (``layers.blockwise_attention``) with their
gradients, ``transformer.forward_train`` with every gradient leaf,
``training.train_step.make_lm_train_step`` (one AdamW step, microbatch
accumulation) and ``launch.train`` (its printed lines, resume, the
resume) against the JAX package on the same weights (carried over by
``convert``) and the same numpy batches: every SMOKE LM at f32 compute,
a dense, the gemma2 and a MoE one at the configs' bf16.

Tolerances. At f32 compute only the order of summation differs: values
and gradients agree within ``F32_TOL`` of each tensor's largest
magnitude (2e-6 seen). At the configs' bf16 compute the packages round at
the same points but after other sums (``tests/test_torch_lm.py``), and a
gradient sums many such roundings: each leaf agrees within
``BF16_GRAD_RMS`` of its RMS (0.0095-0.0221 seen on the SMOKE configs),
the loss within ``BF16_LOSS_TOL``. A MoE layer's token whose k-th and
(k+1)-th router probabilities nearly tie may take other experts in the
two packages at bf16; as ``tests/test_torch_moe.py`` does, the port then
takes the JAX run's experts (the route-flip rule: its own choice may
differ only at a margin within ``ROUTE_TIE``). AdamW's first step moves a
param by lr times its gradient's sign where |g| >> eps, so a gradient
within rounding of 0 can move it by 2 lr the other way. So the update
(new params minus old) is held per leaf: at f32 within ``STEP_RMS`` of
its RMS and ``STEP_ABS`` everywhere (8.4e-5 and 2.2e-6 seen); at bf16 at
most ``STEP_FLIPS`` of its elements differ by more than ``STEP_ABS``
(0.57% seen), none by more than 2 lr.

The JAX train attention takes exp of every score and zeroes the masked
ones after it: where a row's first kv tile holds no attended key (a
window shorter than the sequence) its gradient is NaN. The port's is
finite there, and is held against a dense f64 reference instead.
"""
import contextlib
import dataclasses
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_arch
from repro.launch import train as JT
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JTF
from repro.optim import adamw as JA
from repro.training import train_step as JTS
from repro_torch import tree as T
from repro_torch.configs.registry import get_arch
from repro_torch.convert import adamw_state_from_repro, lm_params_from_repro
from repro_torch.launch import train as TT
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw
from repro_torch.training import train_step as TS

ARCHS = ("stablelm-12b", "gemma2-9b", "qwen3-32b", "moonshot-v1-16b-a3b",
         "llama4-scout-17b-a16e")
F32_TOL = 2e-5
BF16_GRAD_RMS = 0.05
BF16_LOSS_TOL = 1e-3
ROUTE_TIE = 2 ** -10
STEP_RMS = 1e-3
STEP_ABS = 1e-5
STEP_FLIPS = 0.02
LR = 3e-4
B, S = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, dtype, **kw):
    jc, tc = jax_arch(arch).smoke, get_arch(arch).smoke
    if dtype != "config":
        kw["compute_dtype"] = dtype
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _batch(cfg, seed=0, b=B, s=S):
    """Numpy tokens, next-token targets, a mask with row 1's tail off,
    and (llama4) patches."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[-1, s * 5 // 8:] = 0
    out = {"tokens": tok[:, :-1], "targets": tok[:, 1:].copy(),
           "mask": mask}
    if cfg.fused_patches:
        out["patches"] = rng.normal(
            size=(b, cfg.fused_patches, cfg.patch_dim)).astype(np.float32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=F32_TOL):
    got = _np(got)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _rms_ratio(got, want) -> float:
    got = _np(got).astype(np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _port_grads(params, batch, cfg):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in T.leaves(params)]
    loss, metrics = TF.forward_train(T.unflatten(params, leaves), batch, cfg)
    return loss, metrics, torch.autograd.grad(loss, leaves)


# --------------------------------------------------------------------------
# the loss and the train attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_softmax_xent_and_its_gradient_match_jax(dtype, softcap):
    rng = np.random.default_rng(0)
    Bx, Sx, d, V = 2, 48, 16, 40
    x = rng.normal(size=(Bx, Sx, d)).astype(np.float32)
    emb = (rng.normal(size=(V, d)) * 0.5).astype(np.float32)
    tgt = rng.integers(0, V, (Bx, Sx)).astype(np.int32)
    mask = (rng.random((Bx, Sx)) > 0.3).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = L.dt(dtype)

    def jf(x, emb):
        loss, w = JL.chunked_softmax_xent(x.astype(jdt), emb, tgt, mask,
                                          chunk=16, softcap=softcap)
        return loss, w
    (jl, jw), vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(emb))
    jgx, jge = vjp((jnp.float32(1.0), jnp.float32(0.0)))
    tx = torch.from_numpy(x).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    tl, tw = L.chunked_softmax_xent(tx.to(tdt), te, torch.from_numpy(tgt),
                                    torch.from_numpy(mask), chunk=16,
                                    softcap=softcap)
    gx, ge = torch.autograd.grad(tl, [tx, te])
    assert float(tw) == float(jw) == mask.sum()
    if dtype == "float32":
        _close(tl.detach(), jl)
        _close(gx, jgx)
        _close(ge, jge)
    else:
        assert abs(float(tl) - float(jl)) <= BF16_LOSS_TOL * abs(float(jl))
        assert _rms_ratio(gx, jgx) <= BF16_GRAD_RMS
        assert _rms_ratio(ge, jge) <= BF16_GRAD_RMS


def _qkv(rng, Sq, Skv, H=4, KVH=2, D=8):
    return [rng.normal(size=(2, n, h, D)).astype(np.float32)
            for n, h in ((Sq, H), (Skv, KVH), (Skv, KVH))]


@pytest.mark.parametrize("window,softcap,Sq", [(0, 0.0, 64), (24, 0.0, 24),
                                               (0, 50.0, 56),
                                               (32, 50.0, 32)])
def test_train_attention_and_its_gradient_match_jax(window, softcap, Sq):
    """The port's train attention against the JAX training step's
    (``_blockwise_traced_window``), 16 x 16 tiles, at lengths where the
    JAX gradient is finite: causal, a window as long as the sequence,
    softcap, a ragged tail (56)."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, Sq, Sq)
    ct = rng.normal(size=q.shape).astype(np.float32)
    kw = dict(softcap=softcap, block_q=16, block_kv=16)

    def jf(q, k, v):
        return JTF._blockwise_traced_window(q, k, v, window, 0, **kw)
    jo, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jg = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    to = L.blockwise_attention(*ts, causal=True, window=window, **kw)
    tg = torch.autograd.grad(to, ts, torch.from_numpy(ct))
    _close(to.detach(), jo)
    for a, b in zip(tg, jg):
        assert np.isfinite(np.asarray(b)).all()
        _close(a, b)


def test_blockwise_attention_matches_jax_non_causal():
    """``blockwise_attention`` itself (the JAX ``layers`` function), not
    causal, with a window, at a q offset."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 32, 64)
    kw = dict(causal=False, window=20, softcap=0.0, q_offset=16,
              block_q=16, block_kv=32)
    jo = JL.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    to = L.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(to, jo)


def test_windowed_train_attention_gradient_is_finite_where_jaxs_is_nan():
    """Window 16 over 64 tokens in 16 x 16 tiles: rows whose first tile
    holds no attended key. The JAX gradient is NaN there; the port's
    equals a dense softmax's in f64."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 64, 64)
    ct = rng.normal(size=q.shape)
    kw = dict(softcap=0.0, block_q=16, block_kv=16)
    _, vjp = jax.vjp(lambda *a: JTF._blockwise_traced_window(*a, 16, 0, **kw),
                     *map(jnp.asarray, (q, k, v)))
    assert np.isnan(np.asarray(vjp(jnp.asarray(ct, jnp.float32))[0])).any()
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(
        L.blockwise_attention(*ts, causal=True, window=16, **kw), ts,
        torch.from_numpy(ct).float())
    ds = [torch.from_numpy(a).double().requires_grad_(True)
          for a in (q, k, v)]
    qd, kd, vd = ds
    kr, vr = (t.repeat_interleave(2, dim=2) for t in (kd, vd))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kr) / np.sqrt(8)
    pos = torch.arange(64)
    ok = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < 16)
    p = torch.softmax(s.masked_fill(~ok, -np.inf), -1)
    want = torch.autograd.grad(torch.einsum("bhqk,bkhd->bqhd", p, vr), ds,
                               torch.from_numpy(ct))
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        _close(a, b.numpy())


# --------------------------------------------------------------------------
# forward_train and its gradient
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_train(arch, dtype):
    """The JAX loss, metrics and gradient on the SMOKE weights (remat
    off: it changes no value), keeping every MoE call's router
    probabilities."""
    jc, _ = _cfgs(arch, dtype, remat=False)
    params = JTF.init_params(jax.random.PRNGKey(0), jc)
    batch = _batch(jc)
    routes = []
    orig = JTF.moe_ffn

    def hooked(p, x, cfg, cdt, mi=None):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32)
                               @ p["router"], axis=-1)
        jax.debug.callback(lambda a: routes.append(np.asarray(a)), probs,
                           ordered=True)
        return orig(p, x, cfg, cdt, mi=mi)
    JTF.moe_ffn = hooked
    try:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: JTF.forward_train(p, b, jc, JTF.MeshInfo()),
            has_aux=True))(params, _jb(batch))
        jax.effects_barrier()
    finally:
        JTF.moe_ffn = orig
    assert len(routes) == (jc.n_layers if jc.moe else 0)
    return dict(params=jax.tree.map(np.asarray, params), batch=batch,
                loss=float(loss), metrics=jax.tree.map(float, metrics),
                grads=[np.asarray(g, np.float32)
                       for g in jax.tree.leaves(grads)],
                names=[jax.tree_util.keystr(kp) for kp, _ in
                       jax.tree_util.tree_leaves_with_path(grads)],
                routes=routes)


@contextlib.contextmanager
def _jax_routes(probs_per_call, k):
    """While active, the port's MoE layers take the JAX run's experts
    call by call, with gates from their own probabilities; yields the
    port's own choices (sorted sets). Every own choice that differs must
    be a near-tie in the JAX run (checked on exit)."""
    own = []
    orig = M.route

    def forced(router, tokens, top_k):
        probs, _, experts = orig(router, tokens, top_k)
        pj = probs_per_call[len(own)]
        own.append(np.sort(experts.numpy(), -1))
        want = torch.from_numpy(np.argsort(-pj, axis=-1, kind="stable")
                                [:, :top_k].copy())
        gates = torch.gather(probs, -1, want)
        return probs, gates / torch.clamp(gates.sum(-1, keepdim=True),
                                          min=1e-9), want
    M.route = forced
    try:
        yield own
    finally:
        M.route = orig
    assert len(own) == len(probs_per_call)
    for pj, mine in zip(probs_per_call, own):
        jsets = np.sort(np.argsort(-pj, axis=-1, kind="stable")[:, :k], -1)
        diff = (jsets != mine).any(-1)
        srt = -np.sort(-pj, axis=-1)
        assert (srt[diff, k - 1] - srt[diff, k] <= ROUTE_TIE).all()


@pytest.mark.parametrize("arch,dtype", [
    *((a, "float32") for a in ARCHS),
    *((a, "config") for a in ("stablelm-12b", "gemma2-9b",
                              "moonshot-v1-16b-a3b"))])
def test_forward_train_loss_and_every_gradient_leaf_match_jax(arch, dtype):
    ref = _jax_train(arch, dtype)
    _, tc = _cfgs(arch, dtype, remat=False)
    params = lm_params_from_repro(ref["params"])
    route = (_jax_routes(ref["routes"], tc.top_k) if tc.moe
             else contextlib.nullcontext())
    with route:
        loss, metrics, grads = _port_grads(params, _tb(ref["batch"]), tc)
    assert float(metrics["tokens"]) == ref["metrics"]["tokens"] \
        == ref["batch"]["mask"].sum()
    assert len(grads) == len(ref["grads"]) and len(grads) >= 10
    if tc.moe:
        assert float(metrics["aux"]) > 0
    else:
        assert float(metrics["aux"]) == ref["metrics"]["aux"] == 0.0
    if tc.compute_dtype == "float32":
        _close(loss.detach(), ref["loss"])
        _close(metrics["nll"], ref["metrics"]["nll"])
        _close(metrics["aux"], ref["metrics"]["aux"])
        for g, want, name in zip(grads, ref["grads"], ref["names"]):
            assert g.shape == want.shape, name
            _close(g, want)
        return
    assert abs(float(loss) - ref["loss"]) <= BF16_LOSS_TOL * ref["loss"]
    assert abs(float(metrics["aux"]) - ref["metrics"]["aux"]) \
        <= BF16_LOSS_TOL * max(ref["metrics"]["aux"], 1e-3)
    worst = max(_rms_ratio(g, w) for g, w in zip(grads, ref["grads"]))
    assert worst <= BF16_GRAD_RMS, worst


@pytest.mark.parametrize("factor", [0.25, 4.0])
def test_moe_ffn_gradient_matches_jax_with_and_without_drops(factor):
    """``moe_ffn``'s output and aux loss differentiated (a random
    cotangent on the output, 1 on the aux loss) against ``jax.vjp`` of
    the JAX layer, f32: at factor 0.25 most assignments fall into the
    trash slot, whose tokens must get no gradient from them; the gates
    reach the router through ``topk``'s gather. Every leaf and the
    input."""
    jc, tc = _cfgs("moonshot-v1-16b-a3b", "float32",
                   capacity_factor=factor)
    jp = JM.moe_init(jax.random.PRNGKey(1), jc, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, jc.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    (_, jaux), vjp = jax.vjp(
        lambda p, x: JM.moe_ffn(p, x, jc, jnp.float32), jp, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(ct), jnp.float32(1.0)))
    tp = lm_params_from_repro(jax.tree.map(np.asarray, jp))
    leaves = [t.requires_grad_(True) for t in T.leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = M.moe_ffn(T.unflatten(tp, leaves), xt, tc, torch.float32)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum() + aux,
                              [*leaves, xt])
    _close(aux.detach(), jaux)
    for g, w in zip(got, [*jax.tree.leaves(jgp), jgx], strict=True):
        _close(g, w)


def test_remat_changes_no_value():
    """``cfg.remat`` (a checkpoint per layer) recomputes the layers in the
    backward: loss and gradient equal the run without it bit for bit."""
    _, tc = _cfgs("moonshot-v1-16b-a3b", "float32")
    params = TF.init_params(tc, torch.Generator().manual_seed(0))
    batch = _tb(_batch(tc))
    a = _port_grads(params, batch, dataclasses.replace(tc, remat=True))
    b = _port_grads(params, batch, dataclasses.replace(tc, remat=False))
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# the train step, microbatches, the mesh
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step(arch, dtype, n_micro=1):
    jc, _ = _cfgs(arch, dtype)
    params = JTF.init_params(jax.random.PRNGKey(0), jc)
    opt = JA.init(params)
    batch = _batch(jc, seed=3, b=4)
    step = jax.jit(JTS.make_lm_train_step(jc, None, n_microbatch=n_micro))
    np_params = jax.tree.map(np.asarray, params)
    p, o, m = step(params, opt, _jb(batch), jnp.int32(0))
    return dict(params=np_params, batch=batch,
                new_params=jax.tree.map(np.asarray, p),
                opt=jax.tree.map(np.asarray, o), metrics=jax.tree.map(
                    float, m))


def _check_update(got, want, before, dtype):
    """One AdamW step's update per leaf against the reference's (module
    docstring: ``STEP_RMS``, ``STEP_ABS``, ``STEP_FLIPS``)."""
    for a, b, c in zip(T.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(before), strict=True):
        da, db = _np(a) - c, np.asarray(b) - c
        off = np.abs(da - db)
        if dtype == "float32":
            assert _rms_ratio(da, db) <= STEP_RMS
            assert off.max() <= STEP_ABS
        else:
            assert (off > STEP_ABS).mean() <= STEP_FLIPS
            assert off.max() <= 2 * LR * (1 + 1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_train_step_matches_jax(dtype):
    """From converted params and AdamW state: the new params, m, v, count
    and the step's metrics."""
    ref = _jax_step("stablelm-12b", dtype)
    _, tc = _cfgs("stablelm-12b", dtype)
    params = lm_params_from_repro(ref["params"])
    opt = adamw_state_from_repro(JA.init(ref["params"]))
    step = TS.make_lm_train_step(tc)
    p, o, m = step(params, opt, _tb(ref["batch"]), 0)
    assert set(m) == {"loss", "nll", "aux", "tokens", "grad_norm"}
    assert int(o.count) == int(ref["opt"].count) == 1
    tol = F32_TOL if dtype == "float32" else BF16_LOSS_TOL
    for key in ("loss", "nll", "grad_norm"):
        assert abs(float(m[key]) - ref["metrics"][key]) \
            <= tol * abs(ref["metrics"][key]), key
    _check_update(p, ref["new_params"], ref["params"], dtype)
    if dtype == "float32":
        for got, want in ((o.m, ref["opt"].m), (o.v, ref["opt"].v)):
            for a, b in zip(T.leaves(got), jax.tree.leaves(want)):
                _close(a, b)


def test_microbatches_match_the_full_batch_and_jax():
    """``tests/test_training.py`` on the port: 4 microbatches of equal
    token counts give the full batch's loss (rtol 2e-3) and params (rtol
    2e-2, atol 1e-3); and the port's 4-microbatch step matches the JAX
    package's."""
    ref = _jax_step("stablelm-12b", "config", 4)
    _, tc = _cfgs("stablelm-12b", "config")
    batch = ref["batch"]
    batch = {**batch, "mask": np.ones_like(batch["mask"])}
    out = {}
    for n in (1, 4):
        params = lm_params_from_repro(ref["params"])
        opt = adamw.init(params)
        out[n] = TS.make_lm_train_step(tc, n_microbatch=n)(
            params, opt, _tb(batch), 0)
    (p1, _, m1), (p4, _, m4) = out[1], out[4]
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=2e-3)
    for a, b in zip(T.leaves(p1), T.leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2,
                                   atol=1e-3)
    params = lm_params_from_repro(ref["params"])
    p, _, m = TS.make_lm_train_step(tc, n_microbatch=4)(
        params, adamw.init(params), _tb(ref["batch"]), 0)
    assert abs(float(m["loss"]) - ref["metrics"]["loss"]) \
        <= BF16_LOSS_TOL * ref["metrics"]["loss"]
    _check_update(p, ref["new_params"], ref["params"], "bfloat16")


def test_a_mesh_raises():
    _, tc = _cfgs("stablelm-12b", "config")
    params = TF.init_params(tc, torch.Generator().manual_seed(0))
    for make in (TS.make_lm_train_step, TS.make_lm_prefill,
                 TS.make_lm_decode):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make(tc, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        TF.forward_train(params, _tb(_batch(tc)), tc, mesh=object())


def test_prefill_and_decode_steps_are_the_models():
    _, tc = _cfgs("stablelm-12b", "float32")
    params = TF.init_params(tc, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_batch(tc)["tokens"][:, :12]).long()
    caches, logits = TS.make_lm_prefill(tc, pad_to=13)(params,
                                                       {"tokens": toks})
    want = TF.prefill(params, toks, tc, pad_to=13)
    assert torch.equal(logits, want[1])
    lengths = torch.tensor([12, 12])
    _, got = TS.make_lm_decode(tc)(params, caches, lengths, toks[:, 0])
    assert torch.equal(got, TF.decode_step(params, want[0], lengths,
                                           toks[:, 0], tc)[1])


# --------------------------------------------------------------------------
# the driver and the example
# --------------------------------------------------------------------------

def _lines(text):
    """Printed lines with tok/s taken out, and the losses apart."""
    lines, losses = [], []
    for ln in text.splitlines():
        ln = re.sub(r" tok/s [\d,]+", "", ln)
        losses += [float(x) for x in re.findall(r"\d+\.\d{4}", ln)]
        lines.append(re.sub(r"\d+\.\d{4}", "#", ln))
    return lines, losses


def _jax_init_in_the_port(monkeypatch):
    """The port's driver starts from the JAX driver's weights (same seed),
    carried over by ``convert``."""
    def init_state(cfg, seed, device):
        jc = dataclasses.replace(jax_arch("stablelm-12b").smoke)
        assert dataclasses.asdict(jc) == dataclasses.asdict(cfg)
        params = lm_params_from_repro(
            JTF.init_params(jax.random.PRNGKey(seed), jc), device)
        return params, adamw.init(params)
    monkeypatch.setattr(TT, "init_state", init_state)


def test_launch_train_prints_the_jax_drivers_lines(monkeypatch, tmp_path):
    """``launch.train.main --device cpu`` at SMOKE (stablelm), from the
    JAX driver's weights: the printed lines equal the JAX driver's with
    tok/s taken out, losses within ``BF16_LOSS_TOL``; then a resume from
    its last checkpoint continues where it stopped."""
    _jax_init_in_the_port(monkeypatch)
    argv = ["--steps", "4", "--batch", "2", "--seq", "32", "--log-every",
            "1"]
    outs = []
    for mod, extra in ((JT, []), (TT, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(argv + extra)
        outs.append(_lines(buf.getvalue()))
    (jl, jloss), (tl, tloss) = outs
    assert tl == jl and len(tl) == 6
    np.testing.assert_allclose(tloss, jloss, rtol=BF16_LOSS_TOL)
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--resume",
          "auto", "--device", "cpu"]
    first = TT.main(argv + ck)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        more = TT.main(["--steps", "6", *argv[2:]] + ck)
    assert buf.getvalue().splitlines()[0] == "resumed from step 3"
    assert len(first) == 4 and len(more) == 2
    # the resumed steps equal an uninterrupted run's bit for bit
    whole = TT.main(["--steps", "6", *argv[2:], "--device", "cpu"])
    assert whole[:4] == first and whole[4:] == more


def test_launch_train_needs_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.main(["--steps", "1"])
