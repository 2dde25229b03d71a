"""Port parity: the LM serving path of ``repro_torch`` (layers, prefill,
decode, ``generate``, ``DecodeScheduler``) against the JAX package on the
same weights (carried over by ``convert.lm_params_from_repro``) and the
same numpy prompts, for the gemma2, qwen3 and stablelm SMOKE configs.

The prompts are 96 and 100 tokens: past the gemma2 smoke window of 64,
and the 96-token one is right-padded (the ragged tail). Prefill attention
on the CPU is the flash kernel's plain version; the JAX package runs its
blockwise jnp formulation.

Tolerances: at ``compute_dtype=float32`` only the order of summation
differs: logits and caches agree within ``F32_TOL``. At the configs' own
bf16 compute dtype both packages round activations to bf16 at the same
points, but not after the same sums (and the JAX model casts the
attention weights to bf16 before p.v, where the kernel keeps them f32).
Logits then agree within ``BF16_TOL`` (the smoke logits have a standard
deviation of ~0.16; the largest difference seen is 8.3e-3), and caches
within ``BF16_CACHE_TOL`` times the largest magnitude in the cache: rope
mixes each pair, so a rounding of a pair's larger value lands on the
smaller one. Greedy tokens are equal wherever the JAX top-1/top-2 logit
margin exceeds twice the logit tolerance: a row's tokens may first
differ only at a step whose margin is within it (later steps then follow
other prefixes and are not compared).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_arch
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro.serving.scheduler import DecodeScheduler as JaxScheduler
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_repro
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.serving.scheduler import DecodeScheduler, Request

ARCHS = ("gemma2-9b", "qwen3-32b", "stablelm-12b")
F32_TOL = 2e-5
BF16_TOL = 1.5e-2
BF16_CACHE_TOL = 2 ** -5
GEN = 6
LENS = (96, 100)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, dtype):
    """(JAX cfg, port cfg) of ``arch``'s SMOKE at ``dtype`` ("config" keeps
    the config's own compute dtype)."""
    jc, tc = jax_arch(arch).smoke, get_arch(arch).smoke
    if dtype != "config":
        jc = dataclasses.replace(jc, compute_dtype=dtype)
        tc = dataclasses.replace(tc, compute_dtype=dtype)
    return jc, tc


def _prompts(vocab):
    rng = np.random.default_rng(1)
    p = rng.integers(1, vocab, (len(LENS), max(LENS))).astype(np.int32)
    for i, n in enumerate(LENS):
        p[i, n:] = 0
    return p


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype):
    """The JAX package's greedy generation on the smoke weights, as its
    launcher's ``generate`` runs it (jitted prefill padded to S + GEN, then
    decode at each row's length), keeping every step's logits."""
    jc, _ = _cfgs(arch, dtype)
    mi = JTF.MeshInfo()
    params = JTF.init_params(jax.random.PRNGKey(0), jc)
    prompts = _prompts(jc.vocab_size)
    S = prompts.shape[1]
    prefill = jax.jit(lambda p, t: JTF.prefill(p, t, jc, mi, pad_to=S + GEN))
    decode = jax.jit(lambda p, c, l, t: JTF.decode_step(p, c, l, t, jc, mi))
    caches, logits = prefill(params, jnp.asarray(prompts))
    out = {"caches": jax.tree.map(np.asarray, caches), "logits": []}
    lengths = jnp.asarray((prompts > 0).sum(1), jnp.int32)
    toks = []
    for i in range(GEN):
        out["logits"].append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits, -1), np.int32))
        if i < GEN - 1:
            caches, logits = decode(params, caches, lengths + i,
                                    jnp.asarray(toks[-1]))
    out.update(params=jax.tree.map(np.asarray, params), prompts=prompts,
               tokens=np.stack(toks, 1))
    return out


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _assert_tokens_match(got, want, logits, tol):
    """Each row's greedy tokens equal the JAX ones up to the row's first
    difference, which must come at a step whose JAX margin between the
    two best logits is within 2 * tol."""
    for b in range(want.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:
            t = int(diff[0])
            top2 = np.sort(logits[t][b])[-2:]
            assert top2[1] - top2[0] <= 2 * tol, (b, t, got[b], want[b])


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jdt))
    got = L.rmsnorm({"scale": torch.from_numpy(scale)},
                    torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=_tol(dtype) / 3, atol=_tol(dtype) / 3)


@pytest.mark.parametrize("rotary_pct,theta", [(1.0, 10_000.0),
                                              (0.25, 10_000.0),
                                              (1.0, 1_000_000.0)])
def test_apply_rope_full_and_partial(rotary_pct, theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 50, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 50))
    jf, jrot = JL.rope_frequencies(16, rotary_pct, theta)
    tf, trot = L.rope_frequencies(16, rotary_pct, theta)
    assert trot == jrot
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jf, jrot)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tf, trot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    if rotary_pct < 1:   # the features past rot_dim pass through
        assert torch.equal(got[..., trot:], torch.from_numpy(x)[..., trot:])


def test_swiglu_bf16():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.1
         for n, s in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                      ("w_down", (128, 64)))}
    want = JL.swiglu({n: jnp.asarray(a) for n, a in p.items()},
                     jnp.asarray(x, jnp.bfloat16), jnp.bfloat16)
    got = L.swiglu({n: torch.from_numpy(a) for n, a in p.items()},
                   torch.from_numpy(x).to(torch.bfloat16), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 50.0), (40, 0.0)])
def test_decode_attention_window(window, softcap):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 48, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 48, 2, 16)).astype(np.float32)
    lengths = np.array([1, 30, 48])
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lengths), window=window,
                               softcap=softcap)
    got = L.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(lengths),
                             window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS + ("full-gemma2",))
def test_layer_windows(arch):
    if arch == "full-gemma2":
        jc, tc = jax_arch("gemma2-9b").config, get_arch("gemma2-9b").config
    else:
        jc, tc = _cfgs(arch, "config")
    assert TF.layer_windows(tc) == np.asarray(JTF.layer_windows(jc)).tolist()


def test_configs_and_param_tree_match_the_jax_package():
    for arch in ARCHS:
        for name in ("config", "smoke"):
            j, t = (getattr(jax_arch(arch), name), getattr(get_arch(arch),
                                                           name))
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            assert j.param_count() == t.param_count()
    assert get_arch("gemma2-9b").config.param_count() == 9_241_705_984
    jc, tc = _cfgs("gemma2-9b", "config")
    jp = JTF.init_params(jax.random.PRNGKey(0), jc)
    tp = TF.init_params(tc, torch.Generator().manual_seed(0))
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    tshapes = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).removeprefix("torch.")),
                           tp)
    assert jshapes == tshapes
    # the init rule: fan-in stddev for projections, 0.02 for the embedding
    assert abs(float(tp["layers"]["wq"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(tp["embed"].std()) - 0.02) < 0.002


def test_unported_features_and_archs_raise():
    """What the port still refuses: the recsys and GNN archs (``KeyError``
    naming the ROADMAP) and a device mesh (``NotImplementedError``). MoE
    configs and patches are served (``tests/test_torch_moe.py``)."""
    for arch in ("two-tower-retrieval", "nequip"):
        with pytest.raises(KeyError, match="ROADMAP"):
            get_arch(arch)
    _, tc = _cfgs("qwen3-32b", "config")
    params = TF.init_params(tc, torch.Generator().manual_seed(0))
    toks = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="mesh"):
        TF.prefill(params, toks, tc, mesh=object())
    caches, _ = TF.prefill(params, toks, tc, pad_to=5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TF.decode_step(params, caches, torch.tensor([4]), toks[:, 0], tc,
                       mesh=object())


# --------------------------------------------------------------------------
# prefill, decode, generate, scheduler
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches(arch, dtype):
    ref = _jax_run(arch, dtype)
    _, tc = _cfgs(arch, dtype)
    params = lm_params_from_repro(ref["params"])
    prompts = torch.from_numpy(ref["prompts"]).long()
    (k, v), logits = TF.prefill(params, prompts, tc,
                                pad_to=prompts.shape[1] + GEN)
    tol = _tol(dtype)
    np.testing.assert_allclose(logits.numpy(), ref["logits"][0], rtol=tol,
                               atol=tol)
    for got, want in zip((k, v), ref["caches"]):
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        atol = tol if dtype == "float32" \
            else BF16_CACHE_TOL * float(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_teacher_forced(arch, dtype):
    """The port's decode steps, fed the JAX package's greedy tokens at each
    row's length, give the JAX package's logits at every step."""
    ref = _jax_run(arch, dtype)
    _, tc = _cfgs(arch, dtype)
    params = lm_params_from_repro(ref["params"])
    prompts = torch.from_numpy(ref["prompts"]).long()
    caches, _ = TF.prefill(params, prompts, tc,
                           pad_to=prompts.shape[1] + GEN)
    lengths = (prompts > 0).sum(1)
    tol = _tol(dtype)
    for i in range(GEN - 1):
        last = torch.from_numpy(ref["tokens"][:, i]).long()
        caches, logits = TF.decode_step(params, caches, lengths + i, last, tc)
        np.testing.assert_allclose(logits.numpy(), ref["logits"][i + 1],
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens(arch, dtype):
    ref = _jax_run(arch, dtype)
    _, tc = _cfgs(arch, dtype)
    params = lm_params_from_repro(ref["params"])
    stats = {}
    toks = serve.generate(tc, params, torch.from_numpy(ref["prompts"]).long(),
                          GEN, stats=stats)
    assert toks.shape == (len(LENS), GEN)
    assert stats["decode_steps"] == GEN - 1
    _assert_tokens_match(toks.numpy(), ref["tokens"], ref["logits"],
                         _tol(dtype))


def test_decode_scheduler_matches_jax():
    """Two slots, three ragged requests: single-request prefill padded to
    max_len into a slot, refill when a slot finishes, the same finish rule
    (max_new, or the cache nearly full). In f32, so tokens are compared
    outright."""
    jc, tc = _cfgs("gemma2-9b", "float32")
    jp = JTF.init_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, jc.vocab_size, n).astype(np.int32)
               for n in (100, 70, 30)]
    max_new = (5, 3, 4)
    max_len = 104          # the first request stops at the cache's end

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


def test_serve_lm_mode_runs_on_cpu(capsys):
    out = serve.main(["--mode", "lm", "--device", "cpu", "--arch",
                      "stablelm-12b", "--requests", "2", "--prompt-len", "20",
                      "--gen", "3"])
    assert out["tokens"].shape == (2, 3)
    assert out["report"]["tok_per_s"] > 0
    assert "arch=stablelm-smoke served 2 requests" in capsys.readouterr().out
