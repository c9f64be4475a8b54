"""level_retries: materialize-only retries (a survivor-cap miss) and
M-cap escalations per fit (``LevelStats.retried + escalations``, summed
over the levels), averaged over the window's fits."""
LAYER = "level program"
MOVES = "fit_s"
UNIT = "count"


def read(record):
    fits = record["fits"]
    if not fits:
        return None
    return sum(sum(int(s["retried"]) + s["escalations"] for s in f.stats)
               for f in fits) / len(fits)
