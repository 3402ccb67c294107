"""Mean host-clock seconds of the benchmark's span around each
``post_process_segmentation`` call in the window (scipy components)."""


def read(run):
    return run.spans.mean("post_process")
