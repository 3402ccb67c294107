"""Mean host-clock seconds of the benchmark's span around each
``segment_volume`` call in the window (host prep, upload, device work,
readback, scatter)."""


def read(run):
    return run.spans.mean("segment_volume")
