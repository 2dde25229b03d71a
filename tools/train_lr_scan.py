#!/usr/bin/env python3
"""Train stablelm-12b's published widths, cut in depth, at a few learning
rates on a card, and print each run's losses, grad norms and step times.

    python3 tools/train_lr_scan.py                      # 8 layers; 3e-4, 3e-5, 1e-5
    python3 tools/train_lr_scan.py --lrs 1e-4 1e-5 --layers 6
    python3 tools/train_lr_scan.py --out DIR            # where the JSON goes

Each run is ``launch.train``'s loop (``run``) from the same seeded weights
and ``LMBatches`` (seed 0): 6 steps of 2 x 4096 tokens, fp32 params and
AdamW state (no warm-up, as the driver), bf16 compute. It shows which
learning rate ``chip_smoke.py [train]`` can hold to "the loss falls" at
this width: Adam's first steps move every weight by about lr. Needs a
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lrs", nargs="+", default=["3e-4", "3e-5", "1e-5"])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--out", default="build/train_lr_scan")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_lr_scan: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_arch
    from repro_torch.device import gpu_name_and_power_limit, resolve_device
    from repro_torch.launch import train as T
    from repro_torch.training import train_step as TS
    dev = resolve_device("cuda")
    card = gpu_name_and_power_limit()
    cfg = dataclasses.replace(get_arch("stablelm-12b").config,
                              n_layers=args.layers)
    report = {"card": card, "layers": args.layers, "runs": {}}
    for lr in args.lrs:
        targs = T.build_parser().parse_args(
            ["--steps", "6", "--batch", "2", "--seq", "4096", "--lr", lr,
             "--log-every", "1", "--device", str(dev)])
        torch.cuda.reset_peak_memory_stats(dev)
        out = T.run(cfg, TS.make_lm_train_step(cfg, lr=targs.lr), targs,
                    dev)
        run = {k: out[k] for k in ("losses", "grad_norms", "step_s")}
        run["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        report["runs"][lr] = run
        del out
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[lr-scan] on {card}: stablelm-12b widths, {args.layers} "
              f"layers, lr {lr}: losses "
              f"{[round(x, 4) for x in run['losses']]}, grad norms "
              f"{[round(x, 3) for x in run['grad_norms']]}, step s "
              f"{[round(x, 3) for x in run['step_s']]}, peak "
              f"{run['peak_gb']:.2f} GB", flush=True)
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "train_lr_scan.json").write_text(json.dumps(report,
                                                           indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
