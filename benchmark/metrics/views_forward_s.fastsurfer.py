"""Mean self seconds of the program's ``views.forward``
spans per ``views.segment`` call in the traced window."""

from benchmark.program_spans import mean_self_per


def read(run):
    return mean_self_per("views.forward", "views.segment")
