"""AdamW and its schedule, the JAX package's ``repro/optim/adamw.py`` in
PyTorch.

State mirrors the params: ``AdamWState(m, v, count)``. The update math is
fp32 whatever the params' dtype (the params are the fp32 masters; bf16
casts happen inside the model). Unlike the JAX function, ``update``
writes the params, m and v in place, leaf by leaf, under
``torch.no_grad()``: at full width a second copy of the state would not
fit beside the first. It returns what the JAX function returns. Where
the JAX code divides by a device value, so does this (CUDA's
``tensor / python_float`` multiplies by the reciprocal).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import tree as T


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor


def init(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa
    count = torch.zeros((), dtype=torch.int32,
                        device=T.leaves(params)[0].device)
    return AdamWState(m=T.tree_map(zeros, params),
                      v=T.tree_map(zeros, params), count=count)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in T.leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    num = torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(num / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return T.tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def update(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.01, max_grad_norm=1.0):
    """One AdamW step. Returns (params, new_state, {"grad_norm"}): the
    params and the state's m and v are the tensors passed in, updated in
    place; ``count`` is a new tensor."""
    p_leaves, m_leaves, v_leaves = (T.leaves(params), T.leaves(state.m),
                                    T.leaves(state.v))
    g_leaves = [g.to(torch.float32) for g in T.leaves(grads)]
    if not len(p_leaves) == len(g_leaves) == len(m_leaves) == len(v_leaves):
        raise ValueError("params, grads and state differ in shape")
    gnorm = global_norm(g_leaves)
    scale = _clip_scale(gnorm, max_grad_norm) if max_grad_norm else None
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        if scale is not None:
            g = g * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        del g
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) \
            + weight_decay * p.to(torch.float32)
        m.copy_(m_new)
        v.copy_(v_new)
        del m_new, v_new
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
    return params, AdamWState(state.m, state.v, count), {"grad_norm": gnorm}


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; ``lr_at(step)`` is an f32 tensor."""
    def lr_at(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / torch.tensor(float(max(warmup, 1)))
        frac = torch.clamp((step - warmup)
                           / torch.tensor(float(max(total - warmup, 1))),
                           0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr_at
