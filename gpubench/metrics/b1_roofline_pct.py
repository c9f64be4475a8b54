"""b1_roofline_pct: pass 1's kernel B1 (``fused_level_packed``) against
its roofline: the sum over the window's calls of each call's least time
(``harness.roofline``: its bytes over the memory rate or its compares
over the 32-bit rate, counted from the level's candidates and stores)
over the sum of their device times (CUDA events around each launch)."""
from harness.roofline import b1_counts, bound_s

LAYER = "kernels"
MOVES = "fit_s"
UNIT = "%"


def install(hooks):
    """Wrap the program's B1 entry with CUDA events and the work count."""
    import torch
    from repro_torch.kernels import ops

    def make(fn):
        def timed(sched_meta, tiles, gmask, pol, pmask, src, dst, emask):
            if not pol.is_cuda:
                return fn(sched_meta, tiles, gmask, pol, pmask, src, dst,
                          emask)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(sched_meta, tiles, gmask, pol, pmask, src, dst, emask)
            e1.record()
            hooks.data.setdefault("b1", []).append(
                (e0, e1, b1_counts(sched_meta, pol, pmask, src, emask)))
            return out
        return timed

    hooks.patch(ops, "fused_level_packed", make)


def read(record):
    calls = record["hooks"].get("b1")
    if not calls:
        return None
    bound = device = 0.0
    for e0, e1, counts in calls:
        nbytes, compares = counts.tolist()
        bound += bound_s(nbytes, compares)
        device += e0.elapsed_time(e1) / 1e3
    return 100.0 * bound / device if device > 0 else None
