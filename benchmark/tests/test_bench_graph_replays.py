"""The reader of ``unet_graph_replays_per_step.gen`` on synthetic records:
the median over the profiled request's DDIM steps of the UNet's graph
replays (CFG's two calls a step included), 0 for a program that runs the
UNet eagerly, and None where the program records nothing."""

from benchmark import harness, program_trace
from mink_octtree_stablediffusion_tpu_torch.utils.profiling import (
    Record, Span)

NAME = "unet_graph_replays_per_step.gen"


def _request(replays_per_call, calls=1, steps=3):
    rec = Record()
    rec.spans += [Span("serve.generate", 0, 100, None),
                  Span("serve.encode", 0, 5, 0)]
    for _ in range(steps):
        at = len(rec.spans)
        rec.spans.append(Span("sample.step", 0, 10, 0))
        for _ in range(calls):
            counters = ({"unet.graph_replay": replays_per_call}
                        if replays_per_call else {})
            rec.spans.append(Span("unet.forward", 0, 9, at, counters))
        rec.spans.append(Span("scheduler.step", 0, 1, at))
    rec.spans.append(Span("serve.decode", 0, 5, 0))
    return rec


def _read(ctx):
    return harness.metric_reader(NAME)(ctx)


def test_replays_per_step(monkeypatch):
    held = []
    monkeypatch.setattr(program_trace, "program_records", lambda: list(held))
    gen = {"tag": "gen", "trace": {"kernels": [], "spans": [],
                                   "window": (0.0, 1.0)}}
    assert _read(gen) is None  # nothing recorded
    held.append(_request(0))  # the eager UNet: no replay counted
    assert _read(gen) == 0
    held.append(_request(1))
    assert _read(gen) == 1
    held.append(_request(1, calls=2))  # CFG: two replays a step
    assert _read(gen) == 2
    assert _read({"tag": "train", "trace": gen["trace"]}) is None
