"""Device milliseconds per forward over the traced window: the union of
the device's operation intervals in it over the increase of the program's
``engine.synthseg.FORWARDS`` counter (two a scan), so that it includes the
normalisation, flip average, post-process and labels a forward carries."""


def read(run):
    t = run.trace
    forwards = run.counts.get("forwards")
    if t.busy_s is None or not forwards:
        return None
    return 1e3 * t.busy_s / forwards
