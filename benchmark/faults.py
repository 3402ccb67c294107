"""Faults planted in the program's timed path, to show that a cell's check
fails them: the CPU tests plant them in cut runs, ``calibrate.py`` in runs
at the cell's own size on the card, whose readings set the upper end of a
limit. Each is a function ``fault(setattr)`` that replaces one function of
the program through ``setattr(module, name, value)`` (pytest's
``monkeypatch.setattr`` or :func:`planted`)."""

from __future__ import annotations

import contextlib


def flip_one_label(setattr_):
    """An answer altered where it is produced: one candidate's label."""
    from subcort_tpu_torch.engine import infer
    real = infer.segment_volume

    def altered(net, image, atlas, centers, **kw):
        labels, probs = real(net, image, atlas, centers, **kw)
        x, y, z = centers[len(centers) // 2]
        labels[x, y, z] = (int(labels[x, y, z]) + 7) % 15
        return labels, probs

    setattr_(infer, "segment_volume", altered)


def unchanged_state(setattr_):
    """A train step that returns its state unchanged."""
    from subcort_tpu_torch.engine import train
    setattr_(train, "_step_update", lambda net, opt, loss: None)


def half_batch(setattr_):
    """Half of each train batch left out, the mean taken over the rest."""
    from subcort_tpu_torch.engine import train
    real = train._step_loss

    def half(net, opt, views, labels, atlas, *rest):
        h = len(labels) // 2
        return real(net, opt, tuple(v[:h] for v in views), labels[:h],
                    atlas[:h], *rest)

    setattr_(train, "_step_loss", half)


def stuck_row_counter(setattr_):
    """The device row counter of a multistep call never advanced: every
    step of a call trains on the call's first batch."""
    from subcort_tpu_torch.engine import train
    real = train.TrainMultistep.step

    def stuck(self):
        real(self)
        self.slot.sub_(1)

    setattr_(train.TrainMultistep, "step", stuck)


FAULTS = {f.__name__: f for f in (flip_one_label, unchanged_state,
                                  half_batch, stuck_row_counter)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place for the block, the program restored
    after."""
    saved = []

    def set_(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    FAULTS[name](set_)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
