"""Share of the profiled slice's wall time with no operation running on
the card, in percent. Layer: device."""


def read(run):
    sl = run.slice
    if sl is None or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
