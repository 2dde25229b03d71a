"""Port parity: the plain PyTorch version of the flash-attention kernel
(``repro_torch.kernels.flash_attention``, the CPU path of its op) against
the JAX package's Pallas kernel in interpret mode, its ``attention_ref``
and the model's blockwise formulation, on the same numpy inputs.

Tolerances are the JAX kernel test's own (``tests/test_kernels_flash.py``):
2e-5 in f32, where only the order of summation differs (the plain version
materializes the scores, the Pallas kernel walks 64-wide kv blocks), and
2e-2 in bf16, where the output is rounded to bf16 at the end.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro.models.transformer import _blockwise_traced_window
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mk(B, Sq, Skv, H, KVH, D, dtype, seed=0):
    """The same q, k, v for both packages: normal draws from numpy,
    rounded once to ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D))]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


@pytest.mark.parametrize("shape", [
    (1, 128, 128, 4, 4, 64),    # MHA
    (2, 256, 256, 8, 2, 64),    # GQA 4:1
    (1, 192, 320, 4, 2, 128),   # ragged, cross lengths
    (1, 128, 128, 2, 1, 256),   # gemma2's head_dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_and_ref(shape, dtype):
    (jq, jk, jv), (q, k, v) = _mk(*shape, dtype)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jflash(jq, jk, jv, causal=True, block_q=64, block_kv=64),
           _tol(dtype))
    _close(got, jref(jq, jk, jv, causal=True), _tol(dtype))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0),
                                            (0, 50.0), (32, 30.0)])
def test_plain_window_softcap(window, softcap):
    (jq, jk, jv), (q, k, v) = _mk(1, 128, 128, 4, 2, 64, "float32", seed=3)
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=softcap)
    _close(got, jflash(jq, jk, jv, causal=True, window=window,
                       softcap=softcap, block_q=32, block_kv=32), 2e-5)
    _close(got, jref(jq, jk, jv, causal=True, window=window,
                     softcap=softcap), 2e-5)


def test_plain_noncausal_cross_lengths():
    (jq, jk, jv), (q, k, v) = _mk(1, 64, 96, 2, 2, 64, "float32", seed=5)
    got = ops.flash_attention(q, k, v, causal=False)
    _close(got, jflash(jq, jk, jv, causal=False, block_q=32, block_kv=32),
           2e-5)
    _close(got, jref(jq, jk, jv, causal=False), 2e-5)


@pytest.mark.parametrize("D,window,softcap", [(8, 0, 0.0), (8, 24, 50.0),
                                              (16, 0, 30.0), (16, 40, 0.0)])
def test_plain_small_head_dims(D, window, softcap):
    """The smoke configs' head dims (qwen3 8, gemma2/stablelm 16), ragged
    lengths that are not a multiple of the Pallas blocks."""
    (jq, jk, jv), (q, k, v) = _mk(2, 100, 100, 4, 2, D, "float32", seed=D)
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=softcap)
    _close(got, jflash(jq, jk, jv, causal=True, window=window,
                       softcap=softcap, block_q=32, block_kv=32), 2e-5)
    _close(got, jref(jq, jk, jv, causal=True, window=window,
                     softcap=softcap), 2e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (32, 50.0)])
def test_plain_matches_model_blockwise_attention(window, softcap):
    """The kernel's function is the model's prefill attention
    (``transformer._blockwise_traced_window``) in f32."""
    (jq, jk, jv), (q, k, v) = _mk(2, 100, 100, 4, 2, 16, "float32", seed=7)
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=softcap)
    want = _blockwise_traced_window(jq, jk, jv, jnp.int32(window),
                                    jnp.int32(0), softcap=softcap,
                                    block_q=32, block_kv=32)
    _close(got, want, 2e-5)


def test_row_with_nothing_to_attend_is_zero():
    """Causal with Sq > Skv and a window: late rows see no key at all."""
    _, (q, k, v) = _mk(1, 48, 16, 2, 1, 8, "float32", seed=11)
    got = ops.flash_attention(q, k, v, causal=True, window=4)
    assert torch.equal(got[:, 20:], torch.zeros_like(got[:, 20:]))
    assert bool(got[:, :19].abs().sum(-1).gt(0).all())


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    _, (q, k, v) = _mk(1, 40, 40, 4, 2, 16, "bfloat16", seed=2)
    before = dict(_build.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=True, window=8, softcap=50.0)
    want = ref.attention_ref(q, k, v, causal=True, window=8, softcap=50.0)
    assert torch.equal(got, want)
    for route in ("flash_attention", "flash_attention_tc"):
        assert _build.LAUNCHES[route] == before[route]
