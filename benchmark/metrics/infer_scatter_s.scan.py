"""Mean self seconds of the program's ``infer.scatter`` spans per
``infer.segment_volume`` call in the traced window: the results' scatter
into the label volume on the host."""

from benchmark.program_spans import mean_self_per


def read(run):
    return mean_self_per("infer.scatter", "infer.segment_volume")
