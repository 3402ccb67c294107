"""FLOPs of configuration ``fastsurfer_cnn``: FastSurferCNN's three views
over a conformed scan.

Convolutions only, each 2 H W C_in C_out k^2 (BN, PReLU, maxout, pools
and softmax left out), counted from the configuration's widths: per 256 x
256 slice 61,545,119,744 FLOP at 79 classes and 61,310,238,720 at the
sagittal view's 51; a scan of 256 slices a view 47,206,522,421,248 FLOP.
The count comes from the widths, never from the program.
"""


def slice_flops(cfg: dict, num_classes: int) -> int:
    f, k2, c0 = cfg["num_filters"], cfg["kernel_h"] * cfg["kernel_w"], \
        cfg["num_channels"]
    h, w = cfg["height"], cfg["width"]
    total = 0
    for level in range(4):
        hw = (h >> level) * (w >> level)
        c_in = c0 if level == 0 else f
        # encoder block: conv0 (c_in -> f), conv1, the 1x1 conv2
        total += 2 * hw * (c_in * f * k2 + f * f * k2 + f * f)
        # decoder block of the same level
        total += 2 * hw * (2 * f * f * k2 + f * f)
    hw = (h >> 4) * (w >> 4)
    total += 2 * hw * (2 * f * f * k2 + f * f)           # bottleneck
    return total + 2 * h * w * f * num_classes * cfg["kernel_c"] ** 2


def scan_flops(cfg: dict) -> int:
    """FLOP of one scan: every slice of each view."""
    slices = cfg["height"]
    return slices * (2 * slice_flops(cfg, cfg["num_classes"])
                     + slice_flops(cfg, cfg["num_classes_sagittal"]))
