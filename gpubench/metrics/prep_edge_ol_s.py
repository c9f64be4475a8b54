"""prep_edge_ol_s: the edge occurrence lists per fit, from the program's
span ``prep.edge_ol`` (``build_edge_ol`` for every partition and the
stack of their padded stores, ``prep.edge_ol.stack``), averaged over the
window's fits."""
from harness import program_trace

LAYER = "host prep"
MOVES = "fit_s"
UNIT = "s"


def install(hooks):
    program_trace.install(hooks)


def read(record):
    return program_trace.per_fit(record, program_trace.host_s("prep.edge_ol"))
