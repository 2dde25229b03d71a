"""Mixture-of-Experts FFN with sort-based capacity dispatch, the
single-device path of the JAX package's ``repro/models/moe.py``
(GShard/Switch lineage): tokens are routed top-k in f32, assignments
sorted by expert (stably), packed into a static ``(E, C, d)`` buffer with
a trash slot for the assignments past capacity, processed with
per-expert SwiGLU products with f32 results, and combined gate-weighted
back onto their tokens. Tokens beyond capacity are dropped with zero
weight (``capacity_factor`` controls the drop rate). The training step
differentiates it as it stands: gates reach the router through
``core.query.topk``'s gather, and an assignment dropped into the trash
slot gets no gradient (the slot's row is cut off before the experts).

The expert products are plain ``torch.bmm`` (the JAX package computes
them as plain einsums, outside any Pallas kernel). Where the JAX package
asks a bf16 product for an f32 result, a CUDA call asks cuBLAS for an f32
output (``out_dtype``: f32 sums on the bf16 tensor cores); a CPU call
upcasts the operands, whose products are exact in f32. The expert-parallel
path over a device mesh (``moe_ffn_shard_map``) is not ported yet.

Numerics kept from the reference:
  * ``lax.top_k`` puts the lower expert first among equal probabilities
    (``core.query.topk``; ``torch.topk`` does not);
  * ``jnp.argsort`` is stable, and which assignments are dropped past
    capacity follows that order;
  * the combine ``zeros.at[token_of].add(contrib)`` adds each token's k
    contributions left to right in sorted (ascending expert) order from
    +0.0, here k passes over all tokens at once: no float atomics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.query import topk
from repro_torch.models import layers as L


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def capacity(n_tokens: int, top_k: int, n_experts: int, factor: float,
             multiple: int = 8) -> int:
    c = int(n_tokens * top_k * factor / n_experts)
    return max(_round_up(max(c, 1), multiple), multiple)


def moe_init(gen: torch.Generator, cfg, dtype, stack: int = 0) -> dict:
    """The JAX tree: an f32 router (stddev 0.02), the experts' SwiGLU
    weights in ``dtype`` (fan-in stddev over ``E * d`` or ``E * ff``, the
    JAX rule for a 3-D leaf) and, with ``n_shared_experts``, a shared
    SwiGLU ``ff * n_shared_experts`` wide. ``stack``: as
    ``layers.normal_init``."""
    d, ff, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    params = {
        "router": L.normal_init(gen, (d, E), torch.float32, stddev=0.02,
                                stack=stack),
        "w_gate": L.normal_init(gen, (E, d, ff), dtype, stack=stack),
        "w_up": L.normal_init(gen, (E, d, ff), dtype, stack=stack),
        "w_down": L.normal_init(gen, (E, ff, d), dtype, stack=stack),
    }
    if cfg.n_shared_experts:
        params["shared"] = L.swiglu_init(gen, d, ff * cfg.n_shared_experts,
                                         dtype, stack=stack)
    return params


def route(router, tokens, top_k: int):
    """f32 routing of ``tokens`` (T, d): (probs (T, E), gates (T, k)
    renormalised to sum 1, experts (T, k)), the highest probability
    first and the lower expert first among equals."""
    probs = torch.softmax(tokens.to(torch.float32) @ router, dim=-1)
    gate_vals, expert_idx = topk(probs, top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_idx


def expert_load(flat_e, n_experts: int):
    """Assignments per expert (int64): an integer scatter-add, which
    unlike ``torch.bincount`` never waits for the device to size its
    output."""
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))


class _BmmF32(torch.autograd.Function):
    """bf16 (batched) a @ b with f32 results on CUDA, and its gradient as
    JAX transposes a product with ``preferred_element_type``: the f32
    cotangent times the other operand upcast, rounded to the operand's
    dtype (what autograd gives the CPU's upcast operands)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.to(torch.float32).transpose(1, 2)).to(
                a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.to(torch.float32).transpose(1, 2), g).to(
                b.dtype)
        return ga, gb


def _bmm_f32(a, b):
    """a @ b (batched) with f32 results, the JAX package's
    ``preferred_element_type=float32``."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return _BmmF32.apply(a, b)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def moe_ffn(params, x, cfg, compute_dtype):
    """x: (B, S, d) -> ((B, S, d) in x's dtype, the router's aux loss, the
    Switch load-balancing term)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    tokens = x.reshape(T, d)
    dev = x.device

    probs, gate_vals, expert_idx = route(params["router"], tokens, k)
    flat_e = expert_idx.reshape(-1)                       # (T * k,)
    # Switch-style load-balancing aux loss, divided by device values as
    # the JAX package divides (CUDA multiplies by a Python float's
    # reciprocal); its gradient reaches the router through ``probs``
    counts = torch.tensor([float(T * k), float(T)], dtype=torch.float32,
                          device=dev)
    density = expert_load(flat_e, E).to(torch.float32) / counts[0]
    mean_prob = probs.sum(dim=0) / counts[1]
    aux_loss = cfg.router_aux_loss * E * torch.sum(density * mean_prob)

    # --- sort-based dispatch ---
    C = capacity(T, k, E, cfg.capacity_factor)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    token_of = order // k          # originating token per sorted assignment
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < C                                   # capacity drops
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)  # E*C: trash

    gathered = torch.zeros((E * C + 1, d), dtype=compute_dtype, device=dev)
    gathered[slot] = tokens.to(compute_dtype)[token_of]
    gathered = gathered[:-1].reshape(E, C, d)

    # --- per-expert SwiGLU, f32 results ---
    wg = params["w_gate"].to(compute_dtype)
    wu = params["w_up"].to(compute_dtype)
    wd = params["w_down"].to(compute_dtype)
    g = _bmm_f32(gathered, wg)
    u = _bmm_f32(gathered, wu).to(compute_dtype)
    del gathered
    h = F.silu(g).to(compute_dtype) * u
    del g, u
    y = _bmm_f32(h, wd).reshape(E * C, d)
    del h

    # --- gate-weighted combine, each token's k contributions in sorted
    # order: sorted position rank j of token t's assignments is its j-th
    # contribution ---
    sorted_gates = gate_vals.reshape(-1)[order] * keep
    src = torch.where(keep, slot, 0)
    pos_of = torch.empty_like(order)
    pos_of[order] = torch.arange(T * k, device=dev)
    pos_of = torch.sort(pos_of.reshape(T, k), dim=1).values
    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    for j in range(k):
        p = pos_of[:, j]
        out = out + y[src[p]] * sorted_gates[p, None]
    del y

    if cfg.n_shared_experts:
        out = out + L.swiglu(params["shared"], tokens,
                             compute_dtype).to(torch.float32)
    return out.reshape(B, S, d).to(x.dtype), aux_loss
