"""FLOPs of configuration ``synthseg_unet``: SynthSeg's 3D U-Net over a
padded scan.

Convolutions only, each 2 V C_in C_out k^3 at its level's V voxels (BN,
ELU, pools, upsampling, concatenation, softmax and the post-process left
out), counted from the configuration's widths: 2,568,126,726,144 FLOP a
forward at 192 x 224 x 192, and a scan runs two (the flip),
5,136,253,452,288. The count comes from the widths, never from the
program.
"""

import math


def padded_shape(cfg: dict, shape) -> tuple:
    m = int(cfg["pad_multiple"])
    return tuple(-(-int(s) // m) * m for s in shape)


def forward_flops(cfg: dict, shape) -> int:
    """FLOP of one forward over a volume of ``shape`` (already padded)."""
    levels, convs = int(cfg["n_levels"]), int(cfg["nb_conv_per_level"])
    k3 = int(cfg["conv_size"]) ** 3
    f = [int(cfg["unet_feat_count"]) * int(cfg["feat_multiplier"]) ** lv
         for lv in range(levels)]
    vox = [math.prod(shape) // 8 ** lv for lv in range(levels)]
    total, c_in = 0, int(cfg["in_channels"])
    for lv in range(levels):
        for i in range(convs):
            total += 2 * vox[lv] * k3 * (c_in if i == 0 else f[lv]) * f[lv]
        c_in = f[lv]
    for lv in range(levels - 2, -1, -1):
        for i in range(convs):
            c = f[lv + 1] + f[lv] if i == 0 else f[lv]
            total += 2 * vox[lv] * k3 * c * f[lv]
    return total + 2 * vox[0] * f[0] * len(cfg["labels"])


def scan_flops(cfg: dict, shape=(181, 217, 181)) -> int:
    """FLOP of one scan of ``shape``: its forwards over the padded
    volume, two with the flip."""
    passes = 2 if cfg.get("flip", True) else 1
    return passes * forward_flops(cfg, padded_shape(cfg, shape))
