"""setup_s: process start to window start: imports, the program's
kernel library (built on a checkout's first run, loaded after), the
database made from the seed, and the warm-up fit on a slice of it."""
UNIT = "s"


def read(record):
    return record["setup_s"]
