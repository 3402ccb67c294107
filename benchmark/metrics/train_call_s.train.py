"""Self seconds of the program's ``train.call`` spans in the traced window of
``Trainer.fit`` (the second epoch's steps and validation, the first epoch's
checkpoint): the input copies and the enqueue of each call's steps (replays
of the captured step)."""

from benchmark.program_spans import total_self


def read(run):
    return total_self("train.call")
