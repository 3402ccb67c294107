"""Mean self seconds of the program's ``infer.readback`` spans per
``infer.segment_volume`` call in the traced window: the ``.cpu()`` of
labels (and probabilities): the wait for the device's forward and the copy."""

from benchmark.program_spans import mean_self_per


def read(run):
    return mean_self_per("infer.readback", "infer.segment_volume")
