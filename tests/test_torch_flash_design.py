"""The f32 SIMT flash-attention kernel's schedule (``csrc/flash_attention.cu``)
checked on the CPU before the card runs it: a numpy f32 emulation of what
the kernel does, held within the JAX kernel test's 2e-5 against the port's
plain version (``ref.attention_ref``) and the JAX package's Pallas kernel
in interpret mode.

Emulated: the persistent CTAs pulling (batch x head, 64-row q tile) work
items heaviest first from a counter; per item the kv band [kv_begin,
kv_end) cut into 256-row tiles from kv_begin; per tile the scores summed
over 32-d slices of zero-padded q and k, the online softmax (the mask only
on tiles that cross the band's edges or a ragged tail, x / softcap as
x * (1 / softcap)), and p.v over the 32-row v slices the band reaches.
The tile sizes are read from the kernel source.
"""
import heapq
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro_torch.kernels.flash_attention import ref

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "flash_attention.cu").read_text()
NEG = np.float32(-0.7 * np.finfo(np.float32).max)


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1])


BQ, BK, DC = _constant("kBQ"), _constant("kBK"), _constant("kDC")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _band(q0, Sq, Skv, causal, window):
    """The kv rows that hold a live pair for some row of the q tile."""
    kv_end = min(Skv, q0 + BQ, Sq) if causal else Skv
    kv_begin = max(0, q0 - window + 1) if window > 0 else 0
    return kv_begin, max(kv_end - kv_begin, 0)


def _n_chunks(length: int, D: int) -> int:
    """The kernel's closed form: nd k chunks per tile, then 8 v chunks
    (fewer on the last tile)."""
    nd, nt = -(-D // DC), -(-length // BK)
    if nt == 0:
        return 0
    return (nt - 1) * (nd + BK // DC) + nd + -(-(length - (nt - 1) * BK)
                                              // DC)


def _schedule(n_items, cost, n_ctas):
    """Greedy pulls from the counter: each CTA, when free, takes the next
    item. -> (item -> CTA, each CTA's total cost)."""
    free = [(0, c) for c in range(min(n_ctas, n_items))]
    heapq.heapify(free)
    owner, load = {}, [0] * len(free)
    for item in range(n_items):
        t, c = heapq.heappop(free)
        owner[item] = c
        load[c] = t + cost[item]
        heapq.heappush(free, (load[c], c))
    return owner, load


def flash_emulated(q, k, v, causal, window, softcap, n_ctas=5):
    """q (B, Sq, H, D), k/v (B, Skv, KVH, D) f32 -> (out, schedule loads,
    item costs)."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    Dv = max(DC, 1 << (D - 1).bit_length())   # q / v row pitch
    nd = -(-D // DC)
    scale = np.float32(1.0 / math.sqrt(D))
    inv_cap = np.float32(1.0) / np.float32(softcap) if softcap else None
    cap = np.float32(softcap)
    nq, BH = -(-Sq // BQ), B * H
    items = [(nq - 1 - i // BH, i % BH) for i in range(nq * BH)]
    cost = [_n_chunks(_band(qi * BQ, Sq, Skv, causal, window)[1], D) + 1
            for qi, _ in items]
    owner, load = _schedule(len(items), cost, n_ctas)
    assert sorted(owner) == list(range(len(items)))   # each item once
    out = np.zeros_like(q)
    for qi, bh in items:
        b, h = divmod(bh, H)
        kvh = h // (H // KVH)
        q0 = qi * BQ
        kv_begin, length = _band(q0, Sq, Skv, causal, window)
        qs = np.zeros((BQ, Dv), np.float32)          # zero fill
        rows = q[b, q0:q0 + BQ, h]
        qs[:len(rows), :D] = rows
        m = np.full(BQ, NEG, np.float32)
        l = np.zeros(BQ, np.float32)
        acc = np.zeros((BQ, Dv), np.float32)
        qp = q0 + np.arange(BQ)[:, None]
        chunks = 0
        for t in range(-(-length // BK)):
            k0 = kv_begin + t * BK
            kp = k0 + np.arange(BK)[None, :]
            kt = np.zeros((BK, nd * DC), np.float32)
            rows = k[b, k0:k0 + BK, kvh]
            kt[:len(rows), :D] = rows
            s = np.zeros((BQ, BK), np.float32)
            for x in range(nd):
                sl = slice(x * DC, (x + 1) * DC)
                s += qs[:, sl] @ kt[:, sl].T
                chunks += 1
            x = s * scale
            if softcap:
                x = cap * np.tanh(x * inv_cap)
            live = (qp < Sq) & (kp < Skv)
            if causal:
                live &= kp <= qp
            if window > 0:
                live &= qp - kp < window
            inside = (q0 + BQ <= Sq and k0 + BK <= Skv
                      and (not causal or k0 + BK - 1 <= q0)
                      and (window <= 0 or q0 + BQ - 1 - k0 < window))
            if inside:
                assert live.all()
            ok = np.ones_like(live) if inside else live
            m_new = np.maximum(m, np.where(ok, x, NEG).max(axis=1))
            with np.errstate(over="ignore"):   # masked: never taken
                p = np.where(ok, np.exp(x - m_new[:, None]), np.float32(0))
            corr = np.exp(m - m_new)
            l = l * corr + p.sum(axis=1, dtype=np.float32)
            acc *= corr[:, None]
            m = m_new
            n_v = min(BK, length - t * BK)
            for rs in range(-(-n_v // DC)):
                r0 = k0 + rs * DC
                vs = np.zeros((DC, Dv), np.float32)
                rows = v[b, r0:r0 + DC, kvh]
                vs[:len(rows), :D] = rows
                acc += p[:, rs * DC:(rs + 1) * DC] @ vs
                chunks += 1
        assert chunks == _n_chunks(length, D)
        # rows outside the band hold no live pair for this q tile
        kv = np.arange(Skv)[None, :]
        live = np.ones((BQ, Skv), bool)
        if causal:
            live &= kv <= qp
        if window > 0:
            live &= qp - kv < window
        live &= qp < Sq
        outside = (kv < kv_begin) | (kv >= kv_begin + length)
        assert not (live & outside).any()
        n = min(BQ, Sq - q0)
        out[b, q0:q0 + n, h] = (acc[:n, :D]
                                / np.maximum(l[:n], np.float32(1e-30))[:,
                                                                      None])
    return out, load, cost


@pytest.mark.parametrize("shape,kw", [
    # S a multiple of neither tile; the smoke configs' D 8
    ((1, 300, 300, 4, 2, 8), dict(causal=True)),
    # a window edge inside a 256-row tile, softcap 50
    ((1, 300, 300, 4, 2, 8), dict(causal=True, window=100, softcap=50.0)),
    # gemma2's D over three kv tiles, softcap 50
    ((1, 600, 600, 2, 1, 256), dict(causal=True, softcap=50.0)),
    # D 256 with the window's edge inside the first tile of late items
    ((1, 600, 600, 2, 1, 256), dict(causal=True, window=300)),
    # non-causal cross lengths, D 16, GQA 2:1
    ((2, 130, 200, 4, 2, 16), dict(causal=False, softcap=50.0)),
    # D 160 (q / v pitch 256, 5 k chunks), window at a 64-row edge
    ((1, 200, 200, 2, 2, 160), dict(causal=True, window=64, softcap=30.0)),
])
def test_flash_schedule_emulation_matches_refs(shape, kw):
    B, Sq, Skv, H, KVH, D = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D)))
    causal = kw.get("causal", True)
    window, softcap = kw.get("window", 0), kw.get("softcap", 0.0)
    got, load, cost = flash_emulated(q, k, v, causal, window, softcap)
    # greedy pulls heaviest first: no CTA ends more than one item late
    assert max(load) - min(load) <= max(cost)
    want = ref.attention_ref(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=2e-5)
    j_want = jflash(*map(jnp.asarray, (q, k, v)), causal=causal,
                    window=window, softcap=softcap, block_q=64,
                    block_kv=64)
    np.testing.assert_allclose(got, np.asarray(j_want), rtol=2e-5,
                               atol=2e-5)


def test_rows_with_nothing_to_attend_are_zero():
    """Causal with Sq > Skv and a window: late items have an empty band
    (no chunk at all) and write 0."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 200, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, 16, 1, 8)).astype(np.float32)
            for _ in range(2))
    got, _, cost = flash_emulated(q, k, v, True, 4, 0.0)
    assert min(cost) == 1                      # an item with no chunk
    assert (got[:, 19:] == 0).all() and (np.abs(got[:, :19]).sum(-1) > 0).all()
    want = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True,
                             window=4)
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=2e-5)
