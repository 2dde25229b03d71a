"""Train a small LM with checkpointing, then kill and resume it to show
fault tolerance (``examples/train_lm.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]   # CUDA
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu
"""
import argparse
import dataclasses
import shutil
import tempfile

import numpy as np

from repro_torch.launch import train as T


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--hundredm", action="store_true",
                    help="the full ~100M-param config (the default ~12M "
                         "config exercises the identical driver/checkpoint "
                         "path)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu for the plain PyTorch path")
    args = ap.parse_args()

    ckdir = tempfile.mkdtemp(prefix="repro_torch_lm_")
    try:
        import repro_torch.configs.stablelm_12b as S
        if args.hundredm:  # ~100M params (stablelm family, scaled down)
            cfg100m = dataclasses.replace(
                S.CONFIG, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
                head_dim=64, d_ff=1536, vocab_size=32768, scan_layers=True)
        else:  # ~12M params: same family and driver, small enough for a CPU
            cfg100m = dataclasses.replace(
                S.CONFIG, n_layers=6, d_model=320, n_heads=8, n_kv_heads=4,
                head_dim=40, d_ff=1024, vocab_size=16384, scan_layers=True,
                attn_block_q=64, attn_block_kv=64)
        # the driver trains the arch's smoke config: patch this one in
        entry_args = ["--arch", "stablelm-12b",
                      "--steps", str(args.steps),
                      "--batch", str(args.batch), "--seq", str(args.seq),
                      "--ckpt-dir", ckdir, "--ckpt-every", "50",
                      "--resume", "auto"]
        if args.device:
            entry_args += ["--device", args.device]
        import repro_torch.configs.registry as R
        orig = R.get_arch

        def patched(arch_id):
            e = orig(arch_id)
            if arch_id == "stablelm-12b":
                e = dataclasses.replace(e, smoke=cfg100m)
            return e

        R.get_arch = patched
        T.get_arch = patched
        losses = T.main(entry_args)
        assert np.mean(losses[-20:]) < np.mean(losses[:20]), \
            "loss must improve"
        print("\n-- simulating failure + restart (trains 30 more steps) --")
        entry_args[entry_args.index("--steps") + 1] = str(args.steps + 30)
        losses2 = T.main(entry_args)  # resumes from the last checkpoint
        assert losses2, "resume should continue training"
        print("resume OK; training improved loss from "
              f"{np.mean(losses[:10]):.3f} to {np.mean(losses2[-10:]):.3f}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


if __name__ == "__main__":
    main()
