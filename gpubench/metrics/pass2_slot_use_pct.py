"""pass2_slot_use_pct: the share of pass 2's slots that hold a survivor
the next level keeps: 100 × Σ ``useful`` / Σ ``slots`` over the
program's ``level.pass2`` spans of the window (``slots`` = S;
``useful`` = min(survivors, S), or 0 on a level whose store a retry
threw away)."""
from harness import program_trace

LAYER = "level program"
MOVES = "fit_s"
UNIT = "%"


def install(hooks):
    program_trace.install(hooks)


def read(record):
    p2 = [r[5] for r in program_trace.spans(record) if r[0] == "level.pass2"]
    slots = sum(a.get("slots", 0) for a in p2)
    if not slots:
        return None
    return 100.0 * sum(a.get("useful", 0) for a in p2) / slots
