"""wire_wait_s: the host blocked on the level wire per fit, from the
program's span ``level.wait`` (``PendingLevel.finish``: the one
device-to-host copy of a level, its checksum and decode), averaged over
the window's fits."""
from harness import program_trace

LAYER = "level program"
MOVES = "fit_s"
UNIT = "s"


def install(hooks):
    program_trace.install(hooks)


def read(record):
    return program_trace.per_fit(record, program_trace.host_s("level.wait"))
