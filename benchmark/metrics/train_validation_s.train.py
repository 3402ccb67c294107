"""Self seconds of the program's ``train.validation`` spans in the traced
window of ``Trainer.fit`` (the second epoch's steps and validation, the
first epoch's checkpoint): the validation's gathers, eval steps and their
read-back."""

from benchmark.program_spans import total_self


def read(run):
    return total_self("train.validation")
