"""Mean self seconds of the program's ``infer.prepare`` spans per
``infer.segment_volume`` call in the traced window: argument conversion,
the net's dtype, the candidate bbox, the engine's choice and the scan's
normalization statistics."""

from benchmark.program_spans import mean_self_per


def read(run):
    return mean_self_per("infer.prepare", "infer.segment_volume")
