"""The flash-attention op's two CUDA kernels, as far as they reach without
a card: the routing rule (dtype, head dim) -> kernel, the per-source
build flags and the build targets they hash into, the launcher's refusal
of inputs outside the tensor-core route, CPU tensors of either route
launching neither kernel, and the plain version against the JAX Pallas
kernel (interpret mode) at the shapes the tensor-core kernel takes.

The kernels themselves are held against the plain version on the card
(``chip_smoke.py``: 2e-2 in bf16 for the tensor-core kernel, 2e-5 in f32
for the SIMT one)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops, ref

TC, SIMT = "flash_attention_tc", "flash_attention"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 256, TC),    # gemma2-9b, the LM path
    (torch.bfloat16, 128, TC),    # qwen3-32b
    (torch.bfloat16, 160, TC),    # stablelm-12b (padded to 192 inside)
    (torch.bfloat16, 64, TC),
    (torch.bfloat16, 8, SIMT),    # the SMOKE configs' head dims
    (torch.bfloat16, 16, SIMT),
    (torch.bfloat16, 48, SIMT),   # below one 64-column box
    (torch.bfloat16, 72, SIMT),   # not a multiple of 16
    (torch.float32, 256, SIMT),   # f32 is held to 2e-5: never bf16 products
    (torch.float32, 128, SIMT),
    (torch.float32, 160, SIMT),
    (torch.float32, 8, SIMT),
])
def test_route_rule(dtype, D, want):
    assert ops.route(dtype, D) == want
    assert want in _build.LAUNCHES
    source, entry = ops.ROUTES[want]
    assert entry in _build.SIGNATURES[source]


def test_every_source_has_its_flags():
    assert set(_build.SOURCE_FLAGS) == set(_build.SOURCES)
    for name in _build.SOURCES:
        flags = _build.nvcc_flags(name)
        assert flags[:len(_build.COMMON_FLAGS)] == _build.COMMON_FLAGS
        assert "-gencode=arch=compute_90a,code=sm_90a" in flags
        # bit-identity with the plain versions: only the BM25 kernels
        assert ("--fmad=false" in flags) == (name == "bm25_blockmax")


@pytest.mark.parametrize("edited", _build.SOURCES)
def test_editing_one_sources_flags_renames_only_its_target(edited,
                                                           monkeypatch):
    before = {n: _build._target(n) for n in _build.SOURCES}
    monkeypatch.setitem(_build.SOURCE_FLAGS, edited,
                        _build.SOURCE_FLAGS[edited] + ("-DREPRO_PROBE=1",))
    after = {n: _build._target(n) for n in _build.SOURCES}
    for n in _build.SOURCES:
        assert (after[n] != before[n]) == (n == edited), n
        assert after[n].name.startswith(f"{n}-")


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 256),
                                     (torch.bfloat16, 160),
                                     (torch.float32, 256)])
def test_cpu_tensors_launch_neither_kernel(dtype, D):
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(dtype)
               for s in ((1, 70, 4, D), (1, 70, 2, D), (1, 70, 2, D)))
    before = dict(_build.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=True, window=24, softcap=50.0)
    want = ref.attention_ref(q, k, v, causal=True, window=24, softcap=50.0)
    assert torch.equal(got, want)
    assert _build.LAUNCHES[TC] == before[TC]
    assert _build.LAUNCHES[SIMT] == before[SIMT]


def test_launch_refuses_inputs_outside_the_tensor_core_route():
    q = torch.zeros((1, 8, 2, 256), dtype=torch.float32)
    with pytest.raises(ValueError, match="flash_attention_tc takes bf16"):
        ops.launch(TC, q, q, q)
    q = torch.zeros((1, 8, 2, 72), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="flash_attention_tc takes bf16"):
        ops.launch(TC, q, q, q)


@pytest.mark.parametrize("shape,kw", [
    ((1, 100, 100, 8, 1, 128), dict(window=64, softcap=50.0)),   # G = 8
    ((1, 130, 130, 2, 2, 160), dict(window=129)),                # G = 1
    ((2, 70, 70, 4, 2, 256), dict(softcap=50.0)),                # G = 2
    ((1, 48, 80, 4, 2, 64), dict(causal=False)),
])
def test_plain_matches_jax_kernel_on_tensor_core_shapes(shape, kw):
    """The plain version, which the tensor-core kernel is held to on the
    card, against the Pallas kernel in bf16 on that kernel's shapes:
    ragged lengths, windows across tile edges, softcap, G in {1, 2, 8}."""
    B, Sq, Skv, H, KVH, D = shape
    rng = np.random.default_rng(sum(shape))
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D))]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    assert ops.route(q.dtype, D) == TC
    got = ops.flash_attention(q, k, v, **kw)
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                  block_q=32, block_kv=32, **kw)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
