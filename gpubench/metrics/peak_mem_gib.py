"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window
(reset when it opens), in GiB: the occurrence-list stores and pass 2's
temporaries at their largest."""
UNIT = "GiB"


def read(record):
    peak = record.get("peak_bytes")
    return peak / 2**30 if peak else None
