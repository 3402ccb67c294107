"""Mean self seconds of the program's ``infer.upload`` spans per
``infer.segment_volume`` call in the traced window: the host-to-device
copies (pageable) of slab, prior rows, indices and scale."""

from benchmark.program_spans import mean_self_per


def read(run):
    return mean_self_per("infer.upload", "infer.segment_volume")
