"""pass2_device_s: pass 2 on the card per fit: the device seconds between
the CUDA events of the program's device span ``level.pass2`` (the S-slot
loop that materializes the child store), summed and averaged over the
window's fits.  None where the program records no device time (the
CPU)."""
from harness import program_trace

LAYER = "level program"
MOVES = "fit_s"
UNIT = "s"


def install(hooks):
    program_trace.install(hooks)


def _device_s(r):
    return r[5].get("device_s") if r[0] == "level.pass2" else None


def read(record):
    return program_trace.per_fit(record, _device_s)
