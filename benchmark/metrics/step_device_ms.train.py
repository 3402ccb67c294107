"""Device milliseconds per train step over the traced epoch: the union of
the device's operation intervals in it (its steps and its validation
batches) over its steps."""


def read(run):
    t = run.trace
    steps = run.counts.get("traced_steps")
    if t.busy_s is None or not steps:
        return None
    return 1e3 * t.busy_s / steps
