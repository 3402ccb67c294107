"""The quality and training benchmarks (ports of the repo root's
``bench_reg.py``, ``bench_train.py``, ``bench_trainqual.py`` and
``bench_robust.py``), each run as ``python -m
subcort_tpu_torch.bench.<name>`` or through its ``main(argv)`` /
``run(...)``. Each keeps the original's functions, flags, floors and the
keys of its JSON lines, and runs on the card unless ``--mode cpu`` asks
for the CPU."""
