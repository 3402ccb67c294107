"""Self seconds of the program's ``train.loss_readback`` spans in the traced
window of ``Trainer.fit`` (the second epoch's steps and validation, the
first epoch's checkpoint): the ``.tolist()`` of each call's losses: the
host waiting for the call's steps on the device."""

from benchmark.program_spans import total_self


def read(run):
    return total_self("train.loss_readback")
