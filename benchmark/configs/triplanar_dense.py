"""FLOPs of configuration ``triplanar_dense``: the dense à-trous evaluator.

A scan costs one dense slab over the candidates' align-16 bbox plus one
head row per candidate (``frozen.slab_flops``): 780,233,270,760 FLOPs on
the MNI-sized scan of ``frozen.make_scan`` (bbox 80x96x80, 204,403
candidates). The count comes from the inputs, never from the program.
"""

from benchmark import frozen


def scan_flops(cfg: dict, centers, shape) -> int:
    _, dims = frozen.bbox_of(centers, shape)
    return frozen.slab_flops(dims, len(centers), cfg["conv_filters"],
                             cfg["fc_conv"], cfg["fc_fc"], cfg["fc2"],
                             cfg["num_classes"], cfg["atlas_dim"])
