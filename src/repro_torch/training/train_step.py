"""Step factories of the LM family, the single-device half of the JAX
package's ``repro/training/train_step.py``: the training step (loss,
gradient by ``torch.autograd``, microbatch accumulation, AdamW) and the
serving steps.

The GNN and recsys steps are not ported yet, nor are the sharding specs
(``lm_abstract_state``, ``lm_batch_specs``, ``lm_cache_abstract``), which
describe the device mesh (ROADMAP.md, Queue 1). A mesh raises
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw


def _grads(loss_fn, params, batch):
    """(loss, metrics, grads): grads of ``loss_fn(params, batch)`` with
    respect to every leaf of ``params``, through detached aliases of the
    leaves (the params themselves never require grad)."""
    leaves = [t.detach().requires_grad_(True) for t in T.leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(T.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, list(grads)


def make_lm_train_step(cfg, mesh=None, lr: float = 3e-4,
                       n_microbatch: int = 1):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss", "nll", "aux", "tokens", "grad_norm"})``, the params and the
    state updated in place. ``n_microbatch > 1``: gradient accumulation
    over that many slices of the batch (dim 0), summed in f32 and divided
    by their count, the loss the mean of theirs and the other metrics the
    last slice's (grads are the exact mean over microbatches when each
    holds as many tokens)."""
    TF._unsupported(mesh)

    def loss_fn(p, b):
        return TF.forward_train(p, b, cfg)

    def train_step(params, opt_state, batch, step=None):
        if n_microbatch == 1:
            loss, metrics, grads = _grads(loss_fn, params, batch)
        else:
            B = batch["tokens"].shape[0]
            assert B % n_microbatch == 0, (B, n_microbatch)
            mb = B // n_microbatch
            grads, loss = None, 0.0
            for i in range(n_microbatch):
                b = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, metrics, g = _grads(loss_fn, params, b)
                if grads is None:
                    grads = [x.to(torch.float32) for x in g]
                else:
                    for acc, x in zip(grads, g):
                        acc.add_(x)
                del g
                loss = loss + l_i
            n = torch.tensor(float(n_microbatch), dtype=torch.float32,
                             device=loss.device)
            for g in grads:
                g.div_(n)
            loss = loss / n
        params, opt_state, om = adamw.update(
            params, T.unflatten(params, grads), opt_state, lr=lr)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def make_lm_prefill(cfg, mesh=None, pad_to=None):
    TF._unsupported(mesh)

    def prefill_step(params, batch):
        return TF.prefill(params, batch["tokens"], cfg,
                          patches=batch.get("patches"), pad_to=pad_to)

    return prefill_step


def make_lm_decode(cfg, mesh=None):
    TF._unsupported(mesh)

    def decode_step(params, caches, lengths, last_tokens):
        return TF.decode_step(params, caches, lengths, last_tokens, cfg)

    return decode_step
