"""Batched request scheduler for the LM decode loop (the port of the JAX
package's ``repro/serving/scheduler.py``).

Fixed ``slots`` decode slots; finished or empty slots are refilled from
the queue at step boundaries. Admission is a single-request prefill,
padded to ``max_len``, written into the request's slot row of the shared
bf16 KV cache. Every step decodes all slots at once (idle slots too, as
in the JAX version: their writes land in a row the next admission
overwrites).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    generated: list = field(default_factory=list)
    done: bool = False


@dataclass
class DecodeScheduler:
    cfg: object
    params: object
    slots: int
    max_len: int
    device: object = None
    queue: list = field(default_factory=list)
    active: dict = field(default_factory=dict)  # slot -> Request

    def __post_init__(self):
        self.device = resolve_device(self.device)
        cfg = self.cfg
        shape = (cfg.n_layers, self.slots, self.max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        self._caches = (
            torch.zeros(shape, dtype=torch.bfloat16, device=self.device),
            torch.zeros(shape, dtype=torch.bfloat16, device=self.device))
        self._lengths = torch.zeros((self.slots,), dtype=torch.long,
                                    device=self.device)
        self._last = torch.zeros((self.slots,), dtype=torch.long,
                                 device=self.device)

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                     dtype=torch.long, device=self.device)
            (pk, pv), logits = TF.prefill(self.params, prompt, self.cfg,
                                          pad_to=self.max_len)
            k, v = self._caches
            k[:, slot] = pk[:, 0]
            v[:, slot] = pv[:, 0]
            del pk, pv
            self._lengths[slot] = len(req.prompt)
            first = int(torch.argmax(logits[0]))
            req.generated.append(first)
            self._last[slot] = first
            self.active[slot] = req

    def step(self):
        """One decode step over all slots; returns finished requests."""
        self._admit()
        if not self.active:
            return []
        self._caches, logits = TF.decode_step(
            self.params, self._caches, self._lengths, self._last, self.cfg)
        nxt = torch.argmax(logits, dim=-1)
        self._lengths = self._lengths + torch.as_tensor(
            [1 if s in self.active else 0 for s in range(self.slots)],
            dtype=torch.long, device=self.device)
        self._last = nxt
        nxt_host = nxt.tolist()
        lengths_host = self._lengths.tolist()
        finished = []
        for slot, req in list(self.active.items()):
            req.generated.append(nxt_host[slot])
            if len(req.generated) >= req.max_new \
                    or lengths_host[slot] >= self.max_len - 1:
                req.done = True
                finished.append(req)
                del self.active[slot]
        return finished

    def run_to_completion(self, max_steps: int = 10_000):
        out = []
        for _ in range(max_steps):
            out += self.step()
            if not self.active and not self.queue:
                break
        return out
