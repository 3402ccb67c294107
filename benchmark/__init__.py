"""The benchmark of ``subcort_tpu_torch``, the PyTorch / CUDA port, on one
NVIDIA H100: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.

It imports nothing of JAX or of the JAX package. ``BENCHMARK.json`` names the
cells; ``harness.py`` says which files a configuration, a traffic mix, a
cell's limits and a per-layer metric are, so that each is added with new
files and entries only. ``frozen.py`` holds the copies of the program's
generators and counts, ``peaks.py`` the card's published peaks,
``reference/`` the plain references that decide ``correct``, and
``calibrate.py`` reads the numbers the limits are set from.
"""
