"""Device milliseconds per 128^3 window over the traced window: the union
of the device's operation intervals in it over the increase of the
program's ``engine.swinunetr.WINDOWS`` counter (12 an MNI-sized scan), so
that it includes the normalisation, blend, argmax and post-process a
window carries."""


def read(run):
    t = run.trace
    windows = run.counts.get("windows")
    if t.busy_s is None or not windows:
        return None
    return 1e3 * t.busy_s / windows
