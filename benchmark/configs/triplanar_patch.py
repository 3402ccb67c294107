"""FLOPs of configuration ``triplanar_patch``: the network per patch.

One patch forward is 35,407,800 FLOPs at the published widths (three
branches of 11,505,600, the head 891,000; ``frozen.patch_forward_flops``).
A training sample is that forward plus its backward, which takes each
convolution and product twice (the gradient of its input and of its
weights) except the input gradient of each branch's first convolution,
whose input is data: 3 x 35,407,800 - 3 x 324,000 = 105,251,400 FLOPs.
BN, PReLU, pools, the loss and Adam are left out, as in every count here.
"""

from benchmark import frozen


def _widths(cfg: dict) -> dict:
    return dict(conv_filters=cfg["conv_filters"], fc_conv=cfg["fc_conv"],
                fc_fc=cfg["fc_fc"], fc2=cfg["fc2"],
                n_classes=cfg["num_classes"], atlas_dim=cfg["atlas_dim"],
                patch=cfg["patch_size"])


def forward_flops(cfg: dict) -> int:
    return frozen.patch_forward_flops(**_widths(cfg))[0]


def train_flops_per_sample(cfg: dict) -> int:
    total, first = frozen.patch_forward_flops(**_widths(cfg))
    return 3 * total - first


def scan_flops(cfg: dict, centers, shape) -> int:
    return len(centers) * forward_flops(cfg)
