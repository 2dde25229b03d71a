"""End-to-end training driver of the port, with fault tolerance (the JAX
package's ``repro/launch/train.py``).

  python -m repro_torch.launch.train --device cpu --steps 20   # SMOKE
  python -m repro_torch.launch.train --arch qwen3-32b --steps 200 \\
      --batch 8 --seq 256 --ckpt-dir DIR --resume auto          # on CUDA

Without ``--full-config`` it trains the arch's reduced (SMOKE) config;
with it, the published one, which must fit the one device (stablelm-12b
at 40 layers needs 194 GB of fp32 params, grads and AdamW state: the
card's check, ``chip_smoke.py [train]``, runs its published widths at 8
layers through ``run``). Entry points run on CUDA unless given
``--device cpu``, and raise without a card.

Fault tolerance: seeded stateless data (step -> batch), atomic async
checkpoints every ``--ckpt-every`` steps (copied to host memory before
the next step updates the state in place), ``--resume auto`` restarts
from the newest complete step.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import ckpt
from repro_torch.configs.registry import get_arch
from repro_torch.data.lm import LMBatches, Prefetcher
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw
from repro_torch.training import train_step as TS


def build(arch_id: str, *, smoke: bool, mesh=None, lr=3e-4, device=None):
    """(cfg, train_step) of ``arch_id``'s SMOKE or published config;
    raises without a card unless ``device`` is the CPU."""
    resolve_device(device)
    entry = get_arch(arch_id)
    cfg = entry.smoke if smoke else entry.config
    assert cfg.family == "lm", "train.py drives the LM family"
    return cfg, TS.make_lm_train_step(cfg, mesh, lr=lr)


def init_state(cfg, seed: int, device):
    """Random params drawn from ``seed`` on ``device``, and fresh AdamW
    state."""
    params = TF.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    return params, adamw.init(params)


def run(cfg, step_fn, args, device) -> dict:
    """The training loop of ``main``'s ``args`` (steps, batch, seq, seed,
    log_every, ckpt_dir, ckpt_every, resume) over ``cfg``: init (or
    resume), then one ``step_fn`` per step on ``LMBatches`` from the
    prefetcher. Returns the per-step losses, grad norms and wall seconds
    (each synchronized by reading its loss), the init's seconds, the
    first step, and the final params and AdamW state."""
    t_init = time.perf_counter()
    params, opt = init_state(cfg, args.seed, device)
    init_s = time.perf_counter() - t_init
    start = 0
    acp = None
    if args.ckpt_dir:
        acp = ckpt.AsyncCheckpointer(args.ckpt_dir)
        if args.resume == "auto" \
                and ckpt.latest_step(args.ckpt_dir) is not None:
            state, last = ckpt.restore(args.ckpt_dir,
                                       {"params": params, "opt": opt},
                                       device=device)
            params, opt = state["params"], state["opt"]
            start = last + 1
            print(f"resumed from step {last}")

    data = LMBatches(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    pf = Prefetcher(lambda s: data.batch_at(s), start_step=start)
    n_params = sum(t.numel() for t in T.leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"tokens/step={args.batch * args.seq}")

    t0 = time.time()
    losses, grad_norms, step_s = [], [], []
    try:
        for step in range(start, args.steps):
            s, host_batch = pf.get()
            assert s == step, (s, step)
            t1 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in host_batch.items()}
            params, opt, metrics = step_fn(params, opt, batch, step)
            losses.append(float(metrics["loss"]))
            grad_norms.append(float(metrics["grad_norm"]))
            step_s.append(time.perf_counter() - t1)
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.time() - t0
                tps = (step - start + 1) * args.batch * args.seq \
                    / max(dt, 1e-9)
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"tok/s {tps:,.0f}")
            if acp and step > start and step % args.ckpt_every == 0:
                acp.save_async(step, {"params": params, "opt": opt})
        if acp and losses:
            acp.save_async(args.steps - 1, {"params": params, "opt": opt})
            acp.wait()
    finally:
        pf.close()
    if losses:
        print(f"final loss {np.mean(losses[-10:]):.4f} "
              f"(first 10 avg {np.mean(losses[:10]):.4f})")
    else:
        print(f"checkpoint already at step {start - 1} >= --steps; "
              "nothing to do")
    return dict(losses=losses, grad_norms=grad_norms, step_s=step_s,
                init_s=init_s, start=start, params=params, opt=opt)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu for the plain PyTorch path")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg, step_fn = build(args.arch, smoke=not args.full_config, lr=args.lr,
                         device=args.device)
    return run(cfg, step_fn, args, resolve_device(args.device))["losses"]


if __name__ == "__main__":
    main()
