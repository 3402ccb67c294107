"""Mean self seconds of the program's ``postprocess.filter`` spans (the
component filter over the foreground box: staging, the kernel and the
read-back on a card) per ``views.segment`` call in the traced window."""

from benchmark.program_spans import mean_self_per


def read(run):
    return mean_self_per("postprocess.filter", "views.segment")
