"""Port parity for the MoE LMs: ``repro_torch.models.moe`` (``capacity``,
``moe_init``, ``moe_ffn``) and the MoE and early-fusion paths of the
model (``prefill`` with ``patches``, ``decode_step``, ``generate``,
``DecodeScheduler``) against the JAX package on the same weights
(carried over by ``convert.lm_params_from_repro``) and the same numpy
inputs, for the moonshot and llama4 SMOKE configs (llama4: top-1 with a
shared expert, an untied head and 4 patch embeddings).

Tolerances. ``moe_ffn`` alone on identical inputs: at f32 only the order
of summation differs (the router's, the experts' products), so outputs
agree within ``F32_TOL`` (abs and rel) and the aux loss within
``AUX_TOL``; at bf16 both round the dispatched tokens and the SwiGLU's
hidden to bf16 at the same points, within ``BF16_TOL``. The routing is
f32 in both, so identical inputs route identically: a flip would need
two probabilities within the f32 router's rounding (~1e-7). With a router
collapsed onto expert 0 the other experts' probabilities tie exactly,
and only ``lax.top_k``'s lower-index-first order gives the same experts
(and so the same drops past capacity).

The model at f32 compute agrees within ``F32_TOL`` (logits and caches).
At bf16 compute the two packages round activations at other points
(``test_torch_lm.py``), and a token whose k-th and (k+1)-th router
probabilities nearly tie can go to another expert in one package: its
row would then differ far beyond ``BF16_TOL``, and through attention and
the shared capacity so would other rows. The route-flip rule: the JAX
run records every MoE call's router probabilities (a
``jax.debug.callback`` on its ``moe_ffn``), and the port's model takes
the JAX run's experts call by call, with gates from its own
probabilities (``moe.route`` replaced for the test), while recording its
own choice. Wherever its own choice differs, the JAX margin between
that token's k-th and (k+1)-th probability must be within ``ROUTE_TIE``
(a bf16 rounding of the router's input moves a probability by ~1e-4 at
these widths). On the same routing, logits and caches are then held at
every step: within ``F32_TOL`` at f32, within ``BF16_TOL`` at bf16
(caches within ``BF16_CACHE_TOL`` of their largest magnitude), as the
dense models' are. Greedy tokens are equal up to a row's first
difference, which must come at a step whose JAX top-1/top-2 logit
margin is within twice the logit tolerance; routing is checked up to
that step (later calls follow other prefixes).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_arch
from repro.models import moe as JM
from repro.models import transformer as JTF
from repro.serving.scheduler import DecodeScheduler as JaxScheduler
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_repro
from repro_torch.launch import serve
from repro_torch.models import moe as M
from repro_torch.models import transformer as TF
from repro_torch.serving.scheduler import DecodeScheduler, Request

ARCHS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e")
F32_TOL = 2e-5
AUX_TOL = 1e-6
BF16_TOL = 1.5e-2
BF16_CACHE_TOL = 2 ** -5
ROUTE_TIE = 2 ** -10
GEN = 5
LENS = (60, 52)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, dtype, **kw):
    """(JAX cfg, port cfg) of ``arch``'s SMOKE at ``dtype`` ("config" keeps
    the config's own compute dtype) with the fields ``kw``."""
    jc, tc = jax_arch(arch).smoke, get_arch(arch).smoke
    if dtype != "config":
        kw["compute_dtype"] = dtype
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _prompts(vocab):
    rng = np.random.default_rng(1)
    p = rng.integers(1, vocab, (len(LENS), max(LENS))).astype(np.int32)
    for i, n in enumerate(LENS):
        p[i, n:] = 0
    return p


def _patches(cfg):
    return np.random.default_rng(2).standard_normal(
        (len(LENS), cfg.fused_patches, cfg.patch_dim)).astype(np.float32)


def _lax_experts(probs, k):
    """``lax.top_k``'s experts as a set per token: the k largest, the lower
    index first among equals (a stable sort of -probs)."""
    return np.sort(np.argsort(-probs, axis=-1, kind="stable")[:, :k], -1)


def _check_route_flips(want, got, k):
    """Every token whose experts differ between the JAX run's
    probabilities ``want`` and the port's own choices ``got`` (one entry
    per MoE call) is a near-tie in the JAX run (the route-flip rule)."""
    assert len(want) == len(got)
    for c, (pw, own) in enumerate(zip(want, got)):
        diff = (_lax_experts(pw, k) != own).any(-1)
        if diff.any():
            srt = -np.sort(-pw, axis=-1)
            margin = srt[:, k - 1] - srt[:, k]
            assert (margin[diff] <= ROUTE_TIE).all(), (c, margin[diff])


class _JaxRoutes:
    """While active, the port's MoE layers take the JAX run's experts,
    call by call (``lax.top_k`` of its recorded probabilities), with gates
    from the port's own probabilities, and ``own`` records the experts
    the port would have chosen (sorted sets)."""

    def __init__(self, monkeypatch, jax_probs):
        self.own = []
        orig = M.route

        def forced(router, tokens, top_k):
            probs, _, experts = orig(router, tokens, top_k)
            pj = jax_probs[len(self.own)]
            assert pj.shape == tuple(probs.shape)
            self.own.append(np.sort(experts.numpy(), -1))
            want = torch.from_numpy(np.argsort(-pj, axis=-1, kind="stable")
                                    [:, :top_k].copy())
            gates = torch.gather(probs, -1, want)
            return probs, gates / torch.clamp(gates.sum(-1, keepdim=True),
                                              min=1e-9), want
        monkeypatch.setattr(M, "route", forced)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype, patches: bool):
    """The JAX package's greedy generation on the smoke weights, as its
    launcher's ``generate`` runs it (jitted prefill padded to S + GEN, with
    ``patches`` for llama4 if asked, then decode at each row's length),
    keeping every step's logits and every MoE call's router
    probabilities."""
    jc, _ = _cfgs(arch, dtype)
    mi = JTF.MeshInfo()
    params = JTF.init_params(jax.random.PRNGKey(0), jc)
    prompts = _prompts(jc.vocab_size)
    pt = _patches(jc) if patches else None
    S = prompts.shape[1]
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
        prefill = jax.jit(lambda p, t, x: JTF.prefill(p, t, jc, mi, patches=x,
                                                      pad_to=S + GEN))
        decode = jax.jit(lambda p, c, l, t: JTF.decode_step(p, c, l, t, jc,
                                                            mi))
        caches, logits = prefill(params, jnp.asarray(prompts),
                                 None if pt is None else jnp.asarray(pt))
        out = {"caches": jax.tree.map(np.asarray, caches), "logits": []}
        lengths = jnp.asarray((prompts > 0).sum(1), jnp.int32)
        toks = []
        for i in range(GEN):
            out["logits"].append(np.asarray(logits))
            toks.append(np.asarray(jnp.argmax(logits, -1), np.int32))
            if i < GEN - 1:
                caches, logits = decode(params, caches, lengths + i,
                                        jnp.asarray(toks[-1]))
        jax.effects_barrier()
    finally:
        JTF.moe_ffn = orig
    assert len(routes) == GEN * jc.n_layers
    out.update(params=jax.tree.map(np.asarray, params), prompts=prompts,
               patches=pt, tokens=np.stack(toks, 1), routes=routes)
    return out


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


# --------------------------------------------------------------------------
# capacity, init, moe_ffn
# --------------------------------------------------------------------------

def test_capacity_matches_jax_on_a_grid():
    for T in (1, 2, 7, 100, 4096, 16384, 4501):
        for k in (1, 2, 6):
            for E in (4, 8, 16, 64):
                for f in (0.25, 1.0, 1.25, 64 / 6, 16.0):
                    assert M.capacity(T, k, E, f) == JM.capacity(T, k, E, f)
    assert M.capacity(16384, 6, 64, 1.25) == 1920
    assert M.capacity(4, 6, 64, 1.25) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_trees_match_the_jax_package(arch):
    """Configs, parameter counts, the whole model's tree (shapes and
    dtypes, with ``patch_proj`` for llama4) and the init rule: the
    router at 0.02, a 3-D expert leaf at 1/sqrt(E * d) (the JAX fan-in
    rule for ``(E, d, ff)``), ``w_down`` at 1/sqrt(E * ff)."""
    for name in ("config", "smoke"):
        j, t = getattr(jax_arch(arch), name), getattr(get_arch(arch), name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
        assert j.active_param_count() == t.active_param_count()
    jc, tc = _cfgs(arch, "config")
    jp = JTF.init_params(jax.random.PRNGKey(0), jc)
    tp = TF.init_params(tc, torch.Generator().manual_seed(0))
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    tshapes = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).removeprefix("torch.")),
                           tp)
    assert jshapes == tshapes
    assert ("patch_proj" in tp) == bool(tc.fused_patches)
    ffn = tp["layers"]["ffn"]
    E, d, ff = tc.n_experts, tc.d_model, tc.d_ff_expert
    for leaf, want in (("router", 0.02), ("w_gate", (E * d) ** -0.5),
                       ("w_up", (E * d) ** -0.5),
                       ("w_down", (E * ff) ** -0.5)):
        assert abs(float(ffn[leaf].std()) / want - 1) < 0.05, leaf
    bf = M.moe_init(torch.Generator().manual_seed(0), tc, torch.bfloat16,
                    stack=3)
    assert bf["router"].dtype == torch.float32
    assert bf["w_gate"].dtype == torch.bfloat16
    assert bf["w_gate"].shape == (3, E, d, ff)
    assert not torch.equal(bf["w_gate"][0], bf["w_gate"][1])


def _collapsed(params, cfg):
    """The router of ``tests/test_moe.py``'s collapse: expert 0 scores
    10 * sum(x), every other expert 0, so their probabilities tie."""
    r = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    r[:, 0] = 10.0
    return {**params, "router": jnp.asarray(r)}


@pytest.mark.parametrize("collapse", [False, True])
@pytest.mark.parametrize("factor", [0.25, 16.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, dtype, factor, collapse):
    jc, tc = _cfgs(arch, dtype, capacity_factor=factor)
    jp = JM.moe_init(jax.random.PRNGKey(0), jc, jnp.float32)
    if collapse:
        jp = _collapsed(jp, jc)
    x = np.random.default_rng(0).standard_normal(
        (4, 32, jc.d_model)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    want, want_aux = JM.moe_ffn(jp, jnp.asarray(x).astype(jdt), jc, jdt)
    tp = lm_params_from_repro(jax.tree.map(np.asarray, jp))
    xt = torch.from_numpy(x).to(tdt)
    got, aux = M.moe_ffn(tp, xt, tc, tdt)
    assert got.dtype == tdt and got.shape == xt.shape
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL

    T, k, E = 4 * 32, tc.top_k, tc.n_experts
    probs, _, experts = M.route(tp["router"], xt.reshape(T, -1), k)
    assert np.array_equal(np.sort(experts.numpy(), -1),
                          _lax_experts(probs.numpy(), k))
    load = np.bincount(experts.numpy().ravel(), minlength=E)
    C = M.capacity(T, k, E, factor)
    assert (load.max() > C) == (factor < 1)       # drops only at 0.25
    if collapse:   # experts 1.. tie exactly: the lower index goes first
        p = probs.numpy()
        assert (p[:, 1:] == p[:, 1:2]).all()
        picked = np.sort(experts.numpy(), -1)
        assert set(map(tuple, picked)) <= {tuple(range(k)),
                                           tuple(range(1, k + 1))}


# --------------------------------------------------------------------------
# the model: prefill (llama4 with patches), decode, generate, scheduler
# --------------------------------------------------------------------------

def _port_prefill(ref, tc):
    params = lm_params_from_repro(ref["params"])
    prompts = torch.from_numpy(ref["prompts"]).long()
    pt = None if ref["patches"] is None else torch.from_numpy(ref["patches"])
    caches, logits = TF.prefill(params, prompts, tc, patches=pt,
                                pad_to=prompts.shape[1] + GEN)
    return params, prompts, caches, logits


@pytest.mark.parametrize("dtype", ["float32", "config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_teacher_forced(arch, dtype, monkeypatch):
    """Prefill logits and caches, then decode steps fed the JAX package's
    greedy tokens at each row's length, on the JAX run's routing (the
    route-flip rule)."""
    jc, tc = _cfgs(arch, dtype)
    ref = _jax_run(arch, dtype, bool(jc.fused_patches))
    routes = _JaxRoutes(monkeypatch, ref["routes"])
    params, prompts, caches, logits = _port_prefill(ref, tc)
    tol = _tol(dtype)
    np.testing.assert_allclose(logits.numpy(), ref["logits"][0], rtol=tol,
                               atol=tol)
    for got, want in zip(caches, ref["caches"]):
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        atol = tol if dtype == "float32" \
            else BF16_CACHE_TOL * float(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=atol)
    lengths = (prompts > 0).sum(1)
    for i in range(GEN - 1):
        last = torch.from_numpy(ref["tokens"][:, i]).long()
        caches, logits = TF.decode_step(params, caches, lengths + i, last, tc)
        np.testing.assert_allclose(logits.numpy(), ref["logits"][i + 1],
                                   rtol=tol, atol=tol)
    _check_route_flips(ref["routes"], routes.own, tc.top_k)


@pytest.mark.parametrize("dtype", ["float32", "config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens(arch, dtype, monkeypatch):
    ref = _jax_run(arch, dtype, False)
    _, tc = _cfgs(arch, dtype)
    routes = _JaxRoutes(monkeypatch, ref["routes"])
    stats = {}
    toks = serve.generate(tc, lm_params_from_repro(ref["params"]),
                          torch.from_numpy(ref["prompts"]).long(), GEN,
                          stats=stats).numpy()
    assert toks.shape == (len(LENS), GEN)
    assert stats["decode_steps"] == GEN - 1
    tol = _tol(dtype)
    want = ref["tokens"]
    first = GEN
    for b in range(len(LENS)):
        diff = np.nonzero(toks[b] != want[b])[0]
        if diff.size:
            t = int(diff[0])
            first = min(first, t)
            top2 = np.sort(ref["logits"][t][b])[-2:]
            assert top2[1] - top2[0] <= 2 * tol, (b, t, toks[b], want[b])
    # the calls that made tokens 0..first saw the JAX run's inputs
    n = min(first + 1, GEN) * tc.n_layers
    _check_route_flips(ref["routes"][:n], routes.own[:n], tc.top_k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_scheduler_matches_jax(arch):
    """Two slots, three ragged requests (single-request prefill padded to
    max_len into a slot, refill when a slot finishes, the same finish
    rule), at f32 compute, so tokens are compared outright. Each prefill
    routes its own request's tokens alone, and each decode step routes
    both slots' tokens, idle ones included, as in the JAX scheduler."""
    jc, tc = _cfgs(arch, "float32")
    jp = JTF.init_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, jc.vocab_size, n).astype(np.int32)
               for n in (40, 28, 12)]
    max_new = (5, 3, 4)
    max_len = 44          # the first request stops at the cache's end

    def run(sched, req_cls):
        for i, (p, n) in enumerate(zip(prompts, max_new)):
            sched.submit(req_cls(rid=i, prompt=p, max_new=n))
        done = sched.run_to_completion()
        return {r.rid: list(map(int, r.generated)) for r in done}, \
            [r.rid for r in done]

    want, want_order = run(JaxScheduler(cfg=jc, params=jp, mi=JTF.MeshInfo(),
                                        slots=2, max_len=max_len), JaxRequest)
    got, got_order = run(DecodeScheduler(cfg=tc,
                                         params=lm_params_from_repro(jp),
                                         slots=2, max_len=max_len,
                                         device="cpu"), Request)
    assert got == want and got_order == want_order
    assert len(got[0]) == 4   # finished by the cache rule, not max_new


def test_serve_lm_mode_runs_moonshot_on_cpu(capsys):
    out = serve.main(["--mode", "lm", "--device", "cpu", "--arch",
                      "moonshot-v1-16b-a3b", "--param-dtype", "bfloat16",
                      "--requests", "2", "--prompt-len", "20", "--gen", "3"])
    assert out["tokens"].shape == (2, 3)
    assert out["report"]["param_dtype"] == "bfloat16"
    assert out["params"]["layers"]["ffn"]["w_gate"].dtype == torch.bfloat16
    assert out["params"]["layers"]["ffn"]["router"].dtype == torch.float32
    assert out["report"]["peak_gb"] is None
    assert "arch=moonshot-smoke served 2 requests" in capsys.readouterr().out
