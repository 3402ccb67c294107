"""Device milliseconds of SwinUNETR's decoder (the residual blocks, the
transposed convolutions and the output convolution) per window, over the
traced window: the program's ``swinunetr.forward`` spans' ``decoder_ms``
(CUDA events from the encoder's end to the logits of a batch) summed, over
their ``windows``."""

from benchmark.program_spans import spans


def read(run):
    recs = [r for r in spans() if r.name == "swinunetr.forward"
            and "decoder_ms" in r.attrs]
    windows = sum(r.attrs.get("windows", 0) for r in recs)
    if not windows:
        return None
    return sum(r.attrs["decoder_ms"] for r in recs) / windows
