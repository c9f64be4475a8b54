"""level_host_s: the host's part of the levels, per fit: candidate
generation, the schedule, the audit's spot checks and the retries'
host work, i.e. each level's seconds less its dispatch-to-wire seconds
(``LevelStats.seconds - map_seconds``), summed over the levels and
averaged over the window's fits."""
LAYER = "host level work"
MOVES = "fit_s"
UNIT = "s"


def read(record):
    fits = record["fits"]
    if not fits:
        return None
    return sum(sum(s["seconds"] - s["map_seconds"] for s in f.stats)
               for f in fits) / len(fits)
