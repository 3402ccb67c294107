"""The program's own spans in a traced run, for the per-layer metrics with
``"source": "program_span"``.

``subcort_tpu_torch.utils.runtime`` records its spans only while a
``torch.profiler`` records in the process, so in a run with ``--trace 1``
its buffer holds the spans that opened inside the traced window and no
others. A program without the recorder gives none, and every reader then
returns None. A span's self time is its duration less the union of its
children's intervals.
"""

from __future__ import annotations

from collections import defaultdict


def spans() -> list:
    """The program's records, or [] where the program keeps none."""
    try:
        from subcort_tpu_torch.utils import runtime
    except ImportError:
        return []
    records = getattr(runtime, "records", None)
    return list(records()) if records is not None else []


def self_seconds(recs, name: str) -> list:
    """Self seconds of each span named ``name`` in ``recs``."""
    kids = defaultdict(list)
    for r in recs:
        if r.parent is not None:
            kids[r.parent].append((r.start_ns, r.end_ns))
    out = []
    for r in recs:
        if r.name != name:
            continue
        covered, end = 0, r.start_ns
        for a, b in sorted(kids.get(r.id, ())):
            a, b = max(a, end), min(b, r.end_ns)
            if b > a:
                covered += b - a
                end = b
        out.append((r.end_ns - r.start_ns - covered) * 1e-9)
    return out


def mean_self_per(name: str, per: str):
    """Self seconds of every ``name`` span over the number of ``per`` spans
    (a stage's time per call); None without a ``per`` span."""
    recs = spans()
    calls = sum(r.name == per for r in recs)
    if not calls:
        return None
    return sum(self_seconds(recs, name)) / calls


def total_self(name: str):
    """Self seconds of every ``name`` span; None without one."""
    times = self_seconds(spans(), name)
    return sum(times) if times else None
