"""prep_s: host prep (partitioning, edge occurrence lists, the level-1
store and its upload), per fit: the fit's seconds less the program's
per-level seconds (``LevelStats.seconds``), averaged over the window's
fits."""
LAYER = "host prep"
MOVES = "fit_s"
UNIT = "s"


def read(record):
    fits = record["fits"]
    if not fits:
        return None
    return sum(f.seconds - sum(s["seconds"] for s in f.stats)
               for f in fits) / len(fits)
