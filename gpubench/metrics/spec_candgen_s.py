"""spec_candgen_s: the speculative candidate generation per fit, from the
program's span ``level.spec_candgen`` (the next level's candidates made
while a level's device work is in flight, where the cost gate admits
it; 0 in a fit where it refused at every level), averaged over the
window's fits."""
from harness import program_trace

LAYER = "level program"
MOVES = "fit_s"
UNIT = "s"


def install(hooks):
    program_trace.install(hooks)


def read(record):
    return program_trace.per_fit(
        record, program_trace.host_s("level.spec_candgen"))
