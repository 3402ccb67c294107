"""Mean self seconds of the program's ``infer.slab_inputs`` spans per
``infer.segment_volume`` call in the traced window: the host's slab cut,
prior rows and their quantization, per slab."""

from benchmark.program_spans import mean_self_per


def read(run):
    return mean_self_per("infer.slab_inputs", "infer.segment_volume")
