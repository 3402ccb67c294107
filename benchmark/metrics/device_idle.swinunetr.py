"""Share of the traced window, in %, in which no operation ran on the
device: 1 - (union of kernel, copy and set intervals) / window."""


def read(run):
    t = run.trace
    if t.window_s is None or t.busy_s is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
