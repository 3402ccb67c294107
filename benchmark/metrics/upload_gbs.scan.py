"""GB/s of the program's host-to-device uploads in the traced window: the
sum of the ``infer.upload`` spans' ``bytes`` over the sum of their
seconds (pageable copies, each waited for by the host)."""

from benchmark.program_spans import spans


def read(run):
    ups = [r for r in spans() if r.name == "infer.upload"]
    seconds = sum(r.end_ns - r.start_ns for r in ups) * 1e-9
    if not ups or seconds <= 0:
        return None
    return sum(r.attrs["bytes"] for r in ups) / seconds * 1e-9
