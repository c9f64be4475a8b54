"""retry_s: the materialize-only retries per fit, from the program's span
``level.retry`` (a survivor-cap miss or an M escalation: the exact
re-materialization of the level's survivors and the re-bucketing of
their store), averaged over the window's fits."""
from harness import program_trace

LAYER = "host level work"
MOVES = "fit_s"
UNIT = "s"


def install(hooks):
    program_trace.install(hooks)


def read(record):
    return program_trace.per_fit(record, program_trace.host_s("level.retry"))
