"""Device milliseconds of SwinUNETR's encoder (``swinViT``: the patch
embedding, the Swin stages and their merging, the hidden states' norms)
per window, over the traced window: the program's ``swinunetr.forward``
spans' ``encoder_ms`` (CUDA events around the encoder of a batch) summed,
over their ``windows``."""

from benchmark.program_spans import spans


def read(run):
    recs = [r for r in spans() if r.name == "swinunetr.forward"
            and "encoder_ms" in r.attrs]
    windows = sum(r.attrs.get("windows", 0) for r in recs)
    if not windows:
        return None
    return sum(r.attrs["encoder_ms"] for r in recs) / windows
