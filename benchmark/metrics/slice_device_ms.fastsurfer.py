"""Device milliseconds per slice forwarded over the traced window: the
union of the device's operation intervals in it over the increase of the
program's ``engine.views.SLICES`` counter (3 views x 256 thick slices a
scan), so that it includes the conform, aggregation and post-process work
a slice carries."""


def read(run):
    t = run.trace
    slices = run.counts.get("slices")
    if t.busy_s is None or not slices:
        return None
    return 1e3 * t.busy_s / slices
