"""Training on the PyTorch port: a reduced-config LM trained on the
synthetic pipeline with the WSD schedule, preempted at half the steps
and resumed from its latest checkpoint; the loss must fall.

    PYTHONPATH=src python examples/train_lm_torch.py [--arch minicpm-2b] \\
        [--steps 200] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.  The
checkpoints go to ``build/train_lm_torch_ckpt`` beside this script's
repository (``--ckpt-dir`` to move them) and are removed at the end.
"""
import argparse
import shutil
from pathlib import Path

import numpy as np

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.registry import build, get_smoke_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, train_loop

CKPT = Path(__file__).resolve().parent.parent / "build" / "train_lm_torch_ckpt"


def main(argv=None) -> tuple[float, float]:
    """Returns the mean loss of the first and of the last 10 steps."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=str(CKPT))
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    fns = build(cfg, device=args.device, masters=True)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0)
    opt = AdamWConfig(lr=3e-3, schedule="wsd", warmup_steps=20,
                      total_steps=args.steps)
    ckpt = args.ckpt_dir
    shutil.rmtree(ckpt, ignore_errors=True)
    every = max(1, args.steps // 4)

    print(f"=== training {cfg.name} (reduced) for {args.steps} steps on "
          f"{args.device}, WSD schedule, checkpoint every {every} ===")
    half = train_loop(cfg, fns, TrainLoopConfig(
        steps=args.steps // 2, ckpt_every=every, ckpt_dir=ckpt,
        log_every=20), opt, pipe, device=args.device)
    print("--- simulated preemption; resuming from latest checkpoint ---")
    out = train_loop(cfg, fns, TrainLoopConfig(
        steps=args.steps, ckpt_every=every, ckpt_dir=ckpt, log_every=20),
        opt, pipe, device=args.device, resume=True)

    first = float(np.mean(half["losses"][:10]))
    last = float(np.mean(out["losses"][-10:]))
    print(f"loss: {first:.3f} -> {last:.3f}")
    assert last < first, "training must make progress"
    shutil.rmtree(ckpt, ignore_errors=True)
    return first, last


if __name__ == "__main__":
    main()
