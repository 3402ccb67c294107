"""Mean self seconds of the program's ``synthseg.forward``
spans per ``synthseg.segment`` call in the traced window."""

from benchmark.program_spans import mean_self_per


def read(run):
    return mean_self_per("synthseg.forward", "synthseg.segment")
