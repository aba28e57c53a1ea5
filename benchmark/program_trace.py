"""The program's own spans and counters in the profiled slice, for the
per-layer metrics that read them (``benchmark/metrics/``).

The port records a tree of spans and counters a top-level call while a
profiler session records (``utils.profiling``: ``records()``, each record
a top-level span with its nested spans, their counters and the fused conv
launches with their work).  The slice's records are the trailing records
of the cell's top-level span: training, as many ``train.step`` records as
the slice holds ``bench.step`` ranges (a session run again leaves the
records of the one before it in front); generation, the last
``serve.generate`` record.  Every reader gives None where the program
records nothing (a program without the recorder, or a slice without such
records).
"""

from __future__ import annotations

from . import harness, readings, work

TOP = {"train": "train.step", "gen": "serve.generate"}


def program_records() -> list:
    """The program's closed records, oldest first (none where the program
    has no recorder)."""
    from mink_octtree_stablediffusion_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    return list(records()) if records else []


def slice_records(ctx: dict, tag: str) -> list:
    """The records of the profiled slice of a ``tag`` cell."""
    if not readings.for_tag(ctx, tag) or "trace" not in ctx:
        return []
    n = sum(1 for s in ctx["trace"]["spans"] if s[0] == "step") \
        if tag == "train" else 1
    mine = [r for r in program_records() if r.spans[0].name == TOP[tag]]
    return mine[-n:] if n and len(mine) >= n else []


def per_span(ctx: dict, tag: str, unit: str, value) -> list:
    """``value(record, i)`` of each span ``i`` named ``unit`` in the
    slice's records."""
    return [value(rec, i) for rec in slice_records(ctx, tag)
            for i, s in enumerate(rec.spans) if s.name == unit]


def host_ms(ctx: dict, tag: str, unit: str, name: str):
    """The median over the slice's ``unit`` spans of the host ms of the
    spans named ``name`` inside each."""
    values = per_span(ctx, tag, unit, lambda rec, i: sum(
        rec.spans[j].ms for j in rec.within(i)
        if rec.spans[j].name == name))
    return harness.median(values) if values else None


def syncs_per(ctx: dict, tag: str, unit: str):
    """The median over the slice's ``unit`` spans of the syncs counted
    inside each."""
    values = per_span(ctx, tag, unit, lambda rec, i: rec.counter("sync", i))
    return harness.median(values) if values else None


def host_us_per_launch(ctx: dict, tag: str):
    """The host µs of the slice's top-level spans over the device
    operations of the slice's trace."""
    recs = slice_records(ctx, tag)
    ops = len(ctx["trace"]["kernels"]) if recs else 0
    if not ops:
        return None
    return 1e3 * sum(r.spans[0].ms for r in recs) / ops


def counted_roofline(ctx: dict, tag: str):
    """B1–B3's share of their roofline from the work the program counted:
    Σ over the slice's launches of max(ops / 989e12, bytes / 3.35e12) over
    the device time of the fused conv kernels, in %."""
    launches = [x for r in slice_records(ctx, tag) for x in r.launches]
    if not launches:
        return None
    bound = sum(work.bound_seconds(x.ops, x.bytes) for x in launches)
    return readings.fused_roofline({**ctx, "fused_bound_s": bound}, tag)
