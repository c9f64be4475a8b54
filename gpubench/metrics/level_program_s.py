"""level_program_s: the level program, per fit: dispatch to the wire's
arrival on the host (``LevelStats.map_seconds``: pass 1, the shuffle,
compaction, pass 2 and the speculative candgen in its shadow), summed
over the levels and averaged over the window's fits."""
LAYER = "level program"
MOVES = "fit_s"
UNIT = "s"


def read(record):
    fits = record["fits"]
    if not fits:
        return None
    return sum(sum(s["map_seconds"] for s in f.stats)
               for f in fits) / len(fits)
