"""The readers of the program's own spans and counters
(``benchmark/program_trace.py`` and its metrics) on synthetic records and
traces: the choice of the slice's records (a retried session's records in
front of them, another kind of record among them), each reader's value,
and None where the program records nothing."""

import pytest

from benchmark import harness, program_trace, readings, work
from mink_octtree_stablediffusion_tpu_torch.utils.profiling import (
    Launch, Record, Span)

TRAIN = ["forward_host_ms.train", "backward_host_ms.train",
         "optimizer_host_ms.train", "syncs_per_step.train",
         "host_us_per_launch.train", "fused_conv_counted_roofline.train"]
GEN = ["unet_host_ms.gen", "syncs_per_step.gen", "host_us_per_launch.gen",
       "fused_conv_counted_roofline.gen"]
B1_KERNEL = "void (anonymous namespace)::fused_sparse_conv_kernel<128, 64>"


def _record(spans, launches=()):
    """spans: (name, parent index, host ms, syncs)."""
    rec = Record()
    for name, parent, ms, syncs in spans:
        counters = {"sync": syncs} if syncs else {}
        rec.spans.append(Span(name, 0, int(ms * 1e6), parent, counters))
    rec.launches = list(launches)
    return rec


def _step(ms, syncs=0, launches=()):
    """A train step of ``ms`` host ms: forward ms/2, backward ms/4,
    optimizer ms/8, ``syncs`` in its backward."""
    return _record([("train.step", None, ms, 0),
                    ("train.forward", 0, ms / 2, 0),
                    ("train.backward", 0, ms / 4, syncs),
                    ("train.optimizer", 0, ms / 8, 0)], launches)


def _launch(pairs, rows):
    return Launch("B1", 64, 128, 27, 27 * 64 * 128 * 4, 4, 1, pairs=pairs,
                  rows_in=rows, rows_out=rows)


def _trace(steps, kernels):
    spans = [("window", 0.0, 1.0)] + [("step", 0.1 * i, 0.1 * i + 0.1)
                                      for i in range(steps)]
    return {"kernels": kernels, "spans": spans, "window": (0.0, 1.0)}


def _read(name, ctx):
    return harness.metric_reader(name)(ctx)


@pytest.fixture
def recorded(monkeypatch):
    """Records the readers find, as the program would hand them over."""
    held = []
    monkeypatch.setattr(program_trace, "program_records", lambda: list(held))
    return held


def test_train_slice_is_the_trailing_steps_past_a_retried_session(
        recorded):
    kernels = [(B1_KERNEL, 0.0, 0.002)] * 3 + [("elementwise", 0.0, 1e-3)]
    recorded += [_step(999.0, syncs=9) for _ in range(4)]  # a lost session
    recorded.append(_record([("serve.generate", None, 5.0, 0)]))
    steps = [10.0, 30.0, 20.0]
    launch = _launch(1000, 500)
    recorded += [_step(ms, syncs=i, launches=[launch])
                 for i, ms in enumerate(steps)]
    ctx = {"tag": "train", "trace": _trace(3, kernels)}
    assert program_trace.slice_records(ctx, "train") == recorded[-3:]
    got = {n: _read(n, ctx) for n in TRAIN}
    assert got["forward_host_ms.train"] == pytest.approx(10.0)
    assert got["backward_host_ms.train"] == pytest.approx(5.0)
    assert got["optimizer_host_ms.train"] == pytest.approx(2.5)
    assert got["syncs_per_step.train"] == 1
    assert got["host_us_per_launch.train"] == pytest.approx(60e3 / 4)
    bound = 3 * work.bound_seconds(launch.ops, launch.bytes)
    assert got["fused_conv_counted_roofline.train"] == pytest.approx(
        100 * bound / 0.006)
    # the outside recount reads the same share from the same work
    assert readings.fused_roofline({**ctx, "fused_bound_s": bound},
                                   "train") == pytest.approx(
        got["fused_conv_counted_roofline.train"])
    for name in GEN:  # the gen readers read no train cell
        assert _read(name, ctx) is None


def test_gen_slice_is_the_last_request_and_its_steps(recorded):
    def request(unet_ms, syncs, pairs):
        spans = [("serve.generate", None, 100.0, 0),
                 ("serve.encode", 0, 5.0, 0)]
        for ms, s in zip(unet_ms, syncs):
            at = len(spans)
            spans += [("sample.step", 0, ms + 1.0, 0),
                      ("unet.forward", at, ms, s),
                      ("scheduler.step", at, 0.5, 0)]
        spans.append(("serve.decode", 0, 5.0, 1))
        return _record(spans, [_launch(pairs, 100)])
    recorded += [request([50.0] * 3, [7] * 3, 10 ** 6),
                 request([30.0, 10.0, 20.0], [0, 2, 2], 500)]
    kernels = [(B1_KERNEL, 0.0, 1e-3)] + [("gemm", 0.0, 1e-3)] * 3
    ctx = {"tag": "gen", "trace": _trace(0, kernels)}
    assert _read("unet_host_ms.gen", ctx) == pytest.approx(20.0)
    # the decode's sync lies outside every DDIM step
    assert _read("syncs_per_step.gen", ctx) == 2
    assert _read("host_us_per_launch.gen", ctx) == pytest.approx(100e3 / 4)
    launch = recorded[-1].launches[0]
    assert _read("fused_conv_counted_roofline.gen", ctx) == pytest.approx(
        100 * work.bound_seconds(launch.ops, launch.bytes) / 1e-3)


def test_readers_give_none_where_the_program_records_nothing(recorded):
    kernels = [(B1_KERNEL, 0.0, 1e-3)]
    train = {"tag": "train", "trace": _trace(2, kernels)}
    gen = {"tag": "gen", "trace": _trace(0, kernels)}
    untraced = {"tag": "train"}
    for ctx in (train, gen, untraced):  # a program without the recorder
        assert all(_read(n, ctx) is None for n in TRAIN + GEN)
    recorded.append(_step(10.0))  # fewer steps than the slice's
    assert all(_read(n, train) is None for n in TRAIN)


def test_program_records_reads_the_program():
    from mink_octtree_stablediffusion_tpu_torch.utils import profiling

    profiling.clear_records()
    with profiling.recording(), profiling.span("train.step"):
        pass
    try:
        assert [r.spans[0].name for r in program_trace.program_records()] \
            == ["train.step"]
    finally:
        profiling.clear_records()
