"""The scans' share of the card's float32 peak, in %: the configuration's
FLOP count (``configs/swin_unetr.py``: convolutions, linears and the
attention's products, a forward a window, 12 windows an MNI-sized scan) of
each scan completed in the traced window, over the window, over 67
TFLOP/s (float32 outside the tensor cores; the path runs with TF32 off).
A convolution algorithm that does fewer multiplications than the nominal
count (Winograd, FFT) would read high."""

from benchmark import peaks


def read(run):
    if run.trace.window_s is None or not run.counts.get("flops"):
        return None
    return 100.0 * run.counts["flops"] / run.trace.window_s / peaks.FP32_FLOPS
