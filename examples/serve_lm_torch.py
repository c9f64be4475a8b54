"""Serving on the PyTorch port: batched prefill + cached decode, greedy
sampling, for the dense decoder family (qwen2.5-14b, granite-20b,
minicpm-2b, gemma2-2b), the mixture-of-experts family
(deepseek-v2-lite-16b with its latent-attention cache,
phi3.5-moe-42b-a6.6b), the hybrid family (zamba2-2.7b: Mamba2 layers
and one shared attention block), the ssm family (xlstm-1.3b: mLSTM
and sLSTM), the encoder-decoder family (whisper-base) and the VLM family
(qwen2-vl-72b), at the reduced config or, with ``--full``, at the
published widths.  Weights are random, drawn from a seeded generator.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen2.5-14b \\
        [--device cpu] [--full]

Each self-attention layer's cache holds the prompt and the generated
tokens (P + G positions) from the prefill on; a Mamba2, mLSTM or sLSTM
layer carries its recurrent state instead, and a cross-attention layer
the encoder's F frames.  The stub media, as in the JAX example: whisper
gets a batch of mel-frame embeddings (B, encoder_frames, d) drawn from
the seed × 0.02; qwen2-vl a prompt laid out as Qwen2-VL lays one out, an
image of 16 × 16 patch embeddings (drawn the same way) at t = 0, h =
row, w = col, then the text tokens, embedded by the model's own table,
at positions max + 1, … on all three axes, and each generated token fed
back at the next text position.  At full width phi3.5-moe's 83.75 GB
and qwen2-vl-72b's 145.4 GB of bf16 weights do not fit one 80 GB card;
``serve`` takes a config cut in depth.
"""
import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.registry import build, get_config, get_smoke_config

IMAGE_GRID = 16     # qwen2-vl's stub image: 16 x 16 patches


def image_positions(g: int) -> np.ndarray:
    """(3, g·g) t/h/w positions of a g × g patch grid: t = 0, h = row,
    w = col."""
    rows, cols = np.divmod(np.arange(g * g), g)
    return np.stack([np.zeros_like(rows), rows, cols])


def prompt_batch(cfg, model, tokens: torch.Tensor, seed: int = 0):
    """The prefill batch of ``cfg``'s family for the ``(B, S)`` prompt
    ``tokens`` (on the model's device), with its length in cache
    positions.  whisper: the tokens and stub frames; qwen2-vl: the stub
    image's patches then the tokens' embeddings, with their M-RoPE
    positions (text at g, g + 1, … on all three axes); every other
    family: the tokens.  The media are drawn from ``seed``."""
    B, S = tokens.shape
    device = tokens.device
    rng = np.random.default_rng(seed)
    if cfg.family in ("audio", "encdec"):
        frames = rng.normal(size=(B, cfg.encoder_frames, cfg.d_model))
        frames = torch.as_tensor(frames.astype(np.float32) * 0.02,
                                 device=device)
        return {"tokens": tokens, "frames": frames}, S
    if cfg.family == "vlm":
        g = IMAGE_GRID
        patches = rng.normal(size=(B, g * g, cfg.d_model))
        text = F.embedding(tokens, model.embed)
        patches = torch.as_tensor(patches.astype(np.float32) * 0.02,
                                  device=device).to(text.dtype)
        pos = np.concatenate([image_positions(g),
                              np.broadcast_to(g + np.arange(S), (3, S))], 1)
        positions3 = torch.as_tensor(pos, device=device)[:, None].expand(
            3, B, g * g + S)
        return {"embeds": torch.cat([patches, text], 1),
                "positions3": positions3}, g * g + S
    return {"tokens": tokens}, S


def step_batch(cfg, tok: torch.Tensor, pos: int) -> dict:
    """The decode batch of the ``(B, 1)`` tokens fed back at cache
    position ``pos``: qwen2-vl's carry their text position on all three
    M-RoPE axes."""
    if cfg.family == "vlm":
        g = IMAGE_GRID
        return {"tokens": tok, "positions3": torch.full(
            (3, tok.shape[0], 1), pos - g * g + g, device=tok.device)}
    return {"tokens": tok}


def serve(cfg, prompts: np.ndarray, gen_len: int, *, device, seed: int = 0):
    """Random-init ``cfg`` on ``device`` from ``seed``, prefill the
    ``(B, P)`` prompts (with the family's stub media, made before the
    prefill's timer starts) and decode ``gen_len - 1`` more tokens
    greedily.  Returns the ``(B, gen_len)`` generated ids and a dict of
    what was measured: the weight bytes, whether the last logits are
    finite and, on the card, the init seconds (host clock,
    synchronized), the prefill and decode milliseconds (CUDA events;
    decode per token) and the peak device memory."""
    fns = build(cfg, device=device)
    device = torch.device(device)
    on_card = device.type == "cuda"
    G = gen_len
    stats = {}
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = fns["init"](torch.Generator(device).manual_seed(seed))
    stats["weight_bytes"] = sum(p.numel() * p.element_size()
                                for p in model.parameters())
    if on_card:
        torch.cuda.synchronize(device)
        stats["init_s"] = time.perf_counter() - t0
    batch, T = prompt_batch(cfg, model, torch.as_tensor(prompts,
                                                        device=device), seed)
    if on_card:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
    logits, cache = fns["prefill"](model, batch, max_len=T + G)
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    if on_card:
        events[1].record()
    for t in range(G - 1):
        logits, cache = fns["decode"](model, cache,
                                      step_batch(cfg, tok[:, None], T + t),
                                      T + t)
        tok = logits[:, -1].argmax(-1)
        out.append(tok)
    if on_card:
        events[2].record()
        torch.cuda.synchronize(device)
        stats["prefill_ms"] = events[0].elapsed_time(events[1])
        stats["decode_ms_per_token"] = (
            events[1].elapsed_time(events[2]) / max(G - 1, 1))
        stats["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    stats["logits_finite"] = bool(torch.isfinite(logits).all())
    return torch.stack(out, 1).cpu().numpy(), stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the reduced "
                         "config")
    args = ap.parse_args(argv)

    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    rng = np.random.default_rng(0)
    B, P, G = args.batch, args.prompt_len, args.gen_len
    prompts = rng.integers(1, cfg.vocab, (B, P))

    print(f"=== prefill {B}x{P} on {cfg.name} "
          f"({'full width' if args.full else 'reduced'}, {args.device}) ===")
    gen, stats = serve(cfg, prompts, G, device=args.device)
    print(f"greedy generations (token ids), shape {gen.shape}:")
    for b in range(B):
        print(f"  req {b}: {prompts[b][-4:].tolist()} -> "
              f"{gen[b][:12].tolist()}")
    if "prefill_ms" in stats:
        print(f"weights {stats['weight_bytes'] / 1e9:.2f} GB, init "
              f"{stats['init_s']:.2f} s, prefill {stats['prefill_ms']:.2f} "
              f"ms, decode {stats['decode_ms_per_token']:.2f} ms/token, "
              f"peak {stats['peak_bytes'] / 1e9:.2f} GB (CUDA events)")
    print("serving pipeline OK (prefill -> cached decode x%d)" % (G - 1))
    return gen, stats


if __name__ == "__main__":
    main()
