"""Mean self seconds of the program's ``register.affine`` spans per
``register.masks`` call in the traced window."""

from benchmark.program_spans import mean_self_per


def read(run):
    return mean_self_per("register.affine", "register.masks")
