"""Data parallelism over several devices and processes (port of
subcort_tpu/parallel/).

Inference fans out from one process over a list of devices, one host
thread per entry (``mesh.DeviceWorkers``, which
``engine.infer.segment_volume`` deals its slabs and parts over); training
runs one process per device
(``distributed.launch``) with the step's collectives in ``sync_bn``; a
multi-host folder sweep joins one process group (``distributed.initialize``)
and takes its share of the subjects (``distributed.host_shard``).
"""

from subcort_tpu_torch.parallel.distributed import (  # noqa: F401
    all_hosts_mean,
    host_shard,
    initialize,
    launch,
)
from subcort_tpu_torch.parallel.mesh import (  # noqa: F401
    DeviceWorkers,
    available_devices,
    make_devices,
    replicate,
    shard_rows,
)
