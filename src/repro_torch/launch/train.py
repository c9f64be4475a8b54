"""Training launcher on the PyTorch port: ``python -m
repro_torch.launch.train --arch minicpm-2b --smoke --steps 100``.

``--smoke`` selects each architecture's reduced config (same code
path); without it the published config trains, which needs the card
(minicpm-2b's 2.72 B float32 masters, gradients and AdamW moments take
43.6 GB).  Runs on the CUDA card unless ``--device cpu`` is given; with
no card it raises rather than fall back to the CPU.  The audio and VLM
families get the JAX launcher's stub batches: mel-frame embeddings, or
input embeddings with text M-RoPE positions.
"""
from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--schedule", default="cosine",
                    choices=["constant", "cosine", "wsd"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def stub_batches(cfg, seq_len: int, global_batch: int):
    """The JAX launcher's stub inputs of the audio and VLM families, as a
    function of the step (None for the text-only families)."""
    if cfg.family in ("audio", "encdec"):
        def extra(step):
            rng = np.random.default_rng(1000 + step)
            return {"frames": rng.normal(
                size=(global_batch, cfg.encoder_frames, cfg.d_model)
            ).astype(np.float32) * 0.02}
        return extra
    if cfg.family == "vlm":
        def extra(step):
            rng = np.random.default_rng(2000 + step)
            return {
                "embeds": rng.normal(
                    size=(global_batch, seq_len, cfg.d_model)
                ).astype(np.float32) * 0.02,
                "positions3": np.broadcast_to(
                    np.arange(seq_len)[None, None],
                    (3, global_batch, seq_len)).astype(np.int32),
            }
        return extra
    return None


def main(argv=None) -> dict:
    """Trains as the arguments say; returns ``train_loop``'s result."""
    args = parse_args(argv)

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import (build, get_config,
                                             get_smoke_config)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig, train_loop

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    fns = build(cfg, device=args.device, masters=True)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq_len,
                         global_batch=args.global_batch, seed=args.seed)
    out = train_loop(
        cfg, fns,
        TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                        microbatches=args.microbatches, seed=args.seed,
                        log_every=max(1, args.steps // 20)),
        AdamWConfig(lr=args.lr, schedule=args.schedule,
                    warmup_steps=max(1, args.steps // 10),
                    total_steps=args.steps),
        pipe, device=args.device, resume=args.resume,
        extra_batch=stub_batches(cfg, args.seq_len, args.global_batch))
    print(f"[train] done: first-5 loss {np.mean(out['losses'][:5]):.4f} "
          f"-> last-5 {np.mean(out['losses'][-5:]):.4f}")
    return out


if __name__ == "__main__":
    main()
