"""FLOPs of configuration ``swin_unetr``: SwinUNETR over the 128^3 windows
of a scan.

Counted from the configuration's widths, never from the program, as run:
every convolution 2 V C_in C_out k^3 at its output's V voxels (a
transposed one at its input's voxels times k^3), the patch embedding
likewise; per Swin block the qkv and output linears on the padded tokens
(the attention runs on padded windows), the MLP's two linears on the
stage's tokens, and the attention's two products 4 n^2 C a window over
the padded windows of n = 343 tokens; each merging's reduction. Norms,
GELU, softmax, the bias and mask adds, the blend and the post-process are
left out. At the published widths a 128^3 window costs 1,528,187,479,296
FLOP, and an MNI-sized scan (12 windows) 18,338,249,751,552.
"""

import math


def _axis_windows(side: int, roi: int, overlap: float) -> int:
    side = max(side, roi)
    if side == roi:
        return 1
    step = max(int(roi * (1 - overlap)), 1)
    return math.ceil((side - roi) / step) + 1


def windows(cfg: dict, shape) -> int:
    """Windows over a scan of ``shape``."""
    roi = int(cfg["roi"][0])
    return math.prod(_axis_windows(int(s), roi, float(cfg["overlap"]))
                     for s in shape)


def window_flops(cfg: dict, roi=None) -> int:
    """FLOP of one forward over a window of ``roi`` a side."""
    roi = int(roi if roi is not None else cfg["roi"][0])
    f, p = int(cfg["feature_size"]), int(cfg["patch_size"])
    c_in, classes = int(cfg["in_channels"]), int(cfg["out_channels"])
    w, ratio = int(cfg["window_size"]), float(cfg["mlp_ratio"])
    total = 0

    def conv(vox, a, b, k):
        return 2 * vox * a * b * k ** 3

    # encoder: patch embedding, then four stages at C f 2^s, side roi/2^(s+1)
    side = roi // p
    total += conv(side ** 3, c_in, f, p)
    for s, depth in enumerate(cfg["depths"]):
        c = f * 2 ** s
        win = min(side, w)
        padded = -(-side // win) * win
        tokens, padded_tokens, n = side ** 3, padded ** 3, win ** 3
        block = (2 * padded_tokens * c * 3 * c + 2 * padded_tokens * c * c
                 + 2 * 2 * tokens * c * int(ratio * c)
                 + 4 * n * n * c * (padded_tokens // n))
        total += depth * block
        side //= 2
        total += 2 * side ** 3 * 8 * c * 2 * c
    # decoder: res blocks (two 3^3 convs, a 1^3 residual where widths
    # differ) and up blocks (transposed conv 2^3, then a res block)
    v = [roi ** 3 // 8 ** i for i in range(6)]

    def res(vox, a, b):
        return (conv(vox, a, b, 3) + conv(vox, b, b, 3)
                + (conv(vox, a, b, 1) if a != b else 0))

    total += res(v[0], c_in, f) + res(v[1], f, f) + res(v[2], 2 * f, 2 * f)
    total += res(v[3], 4 * f, 4 * f) + res(v[5], 16 * f, 16 * f)
    for level, (a, b) in enumerate(((16 * f, 8 * f), (8 * f, 4 * f),
                                    (4 * f, 2 * f), (2 * f, f), (f, f))):
        out_vox = v[4 - level]
        total += 2 * (out_vox // 8) * a * b * 8 + res(out_vox, 2 * b, b)
    return total + conv(v[0], f, classes, 1)


def scan_flops(cfg: dict, shape=(181, 217, 181)) -> int:
    """FLOP of one scan of ``shape``: a forward a window."""
    return windows(cfg, shape) * window_flops(cfg)
