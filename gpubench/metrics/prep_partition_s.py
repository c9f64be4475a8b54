"""prep_partition_s: ``make_partitions`` per fit, from the program's own
spans (``prep.partition.validate``, ``.filter`` and ``.split``: input
validation, the infrequent-edge filter, the partition split), summed and
averaged over the window's fits."""
from harness import program_trace

LAYER = "host prep"
MOVES = "fit_s"
UNIT = "s"


def install(hooks):
    program_trace.install(hooks)


def read(record):
    return program_trace.per_fit(
        record, program_trace.host_s("prep.partition", prefix=True))
