"""Mean self seconds of the program's ``infer.forward`` spans per
``infer.segment_volume`` call in the traced window: the host's enqueue of
the dense forward (``fcn_forward_slab``)."""

from benchmark.program_spans import mean_self_per


def read(run):
    return mean_self_per("infer.forward", "infer.segment_volume")
