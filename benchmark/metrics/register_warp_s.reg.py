"""Mean self seconds of the program's ``register.prior_warp`` and
``register.mask`` spans together per ``register.masks`` call in the traced
window: the prior warp (its NIfTI reads and writes, ``register.io``, not
counted) and the ROI mask."""

from benchmark.program_spans import mean_self_per


def read(run):
    warp = mean_self_per("register.prior_warp", "register.masks")
    mask = mean_self_per("register.mask", "register.masks")
    if warp is None:
        return None
    return warp + (mask or 0.0)
