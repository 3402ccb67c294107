"""Self seconds of the program's ``train.checkpoint`` spans in the traced
window of ``Trainer.fit`` (the second epoch's steps and validation, the
first epoch's checkpoint): the epoch's writes: the weights pickle when
validation improved, the history JSONL and pickle, the state pickle."""

from benchmark.program_spans import total_self


def read(run):
    return total_self("train.checkpoint")
