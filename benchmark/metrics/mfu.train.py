"""The traced epoch's share of the card's float32 peak, in %: its trained
rows at the configuration's training FLOPs per sample plus its validation
rows at one forward each, over the traced window, over 67 TFLOP/s."""

from benchmark import peaks


def read(run):
    t = run.trace
    c = run.counts
    if t.window_s is None or not c.get("traced_train_samples"):
        return None
    cfg, fl = run.cell.config, run.cell.flops
    work = (c["traced_train_samples"] * fl.train_flops_per_sample(cfg)
            + c.get("traced_eval_samples", 0) * fl.forward_flops(cfg))
    return 100.0 * work / t.window_s / peaks.FP32_FLOPS
