"""fit_s: the seconds to the complete, exact frequent set, host prep
included, as the user waits for it: the window's seconds over the whole
fits it holds (host clock; the device's queue drained at each fit's
end)."""
UNIT = "s"


def read(record):
    fits = record["fits"]
    return record["window_s"] / len(fits) if fits else None
