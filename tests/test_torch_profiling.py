"""The port's recorder of spans and counters (``utils/profiling.py``) on
the CPU: nesting, parents and counters; recording off (no record, no
``record_function``, no sync debug mode, no work slot) and on under a
``torch.profiler`` session (``mink.*`` ranges nested as the records are);
the spans of a train step and of a 2-step generation request; the sync
counter's warning path; and the work a fused conv launch records, against
``benchmark/work.py::launch_work`` (no JAX).
"""

import threading
import warnings

import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv as fc
from mink_octtree_stablediffusion_tpu_torch.ops import library
from mink_octtree_stablediffusion_tpu_torch.ops.coords import INT32_MAX
from mink_octtree_stablediffusion_tpu_torch.utils import profiling

SYNC = "called a synchronizing CUDA operation"


@pytest.fixture(autouse=True)
def _fresh_records():
    profiling.clear_records()
    yield
    profiling.clear_records()


def _shape(rec):
    """(name, parent name) of each span of a record, in opening order."""
    return [(s.name, None if s.parent is None else rec.spans[s.parent].name)
            for s in rec.spans]


def test_spans_nest_with_parents_and_count_on_the_innermost_span():
    with profiling.recording():
        with profiling.span("outer"):
            profiling.count("a")
            with profiling.span("inner"):
                profiling.count("a", 2)
                with profiling.span("leaf"):
                    profiling.count("b", 5)
            profiling.count("a")
    rec, = profiling.records()
    assert _shape(rec) == [("outer", None), ("inner", "outer"),
                           ("leaf", "inner")]
    assert [s.counters for s in rec.spans] == [{"a": 2}, {"a": 2}, {"b": 5}]
    assert rec.counter("a") == 4 and rec.counter("a", 2) == 0
    assert rec.within(1) == [1, 2]
    outer, inner, leaf = rec.spans
    assert outer.start_ns <= inner.start_ns <= leaf.start_ns
    assert leaf.end_ns <= inner.end_ns <= outer.end_ns
    profiling.count("a")  # no span open: nothing to count on
    assert profiling.work_slot("cpu") is None
    with profiling.recording():
        for _ in range(profiling.MAX_RECORDS + 6):
            with profiling.span("later"):
                pass
    recs = profiling.records()
    assert [r.spans[0].name for r in recs] == ["later"] * profiling.MAX_RECORDS


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


def test_a_thread_with_no_span_counts_on_the_one_open_record():
    """As the autograd engine's threads run a backward's functions for the
    thread that waits in ``backward()``; with two records open, another
    thread's counts go nowhere."""
    with profiling.recording():
        with profiling.span("step"), profiling.span("backward"):
            _in_thread(lambda: profiling.count("launch"))
        with profiling.span("main"):
            opened, done = threading.Event(), threading.Event()

            def other():
                with profiling.span("prefetch"):  # a record of its own
                    opened.set()
                    done.wait(timeout=30)
            t = threading.Thread(target=other)
            t.start()
            opened.wait(timeout=30)
            _in_thread(lambda: profiling.count("launch"))
            done.set()
            t.join(timeout=30)
            assert not t.is_alive()
    step, prefetch, main = profiling.records()
    assert [s.counters for s in step.spans] == [{}, {"launch": 1}]
    assert prefetch.counter("launch") == main.counter("launch") == 0


def test_recording_off_leaves_no_record_range_mode_or_slot(monkeypatch):
    calls, ranges = [], []
    real_range = torch.profiler.record_function
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", calls.append)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: ranges.append(name) or real_range(name))
    filters, show = list(warnings.filters), warnings.showwarning
    with profiling.span("off"):
        with profiling.span("nested"):
            profiling.count("x")
            assert profiling.work_slot("cpu") is None
    assert profiling.records() == [] and calls == [] and ranges == []
    assert warnings.filters == filters and warnings.showwarning is show
    with profiling.recording():
        with profiling.span("on"):
            assert calls == ["warn"]
        # torch.export and torch.compile trace no span
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        with profiling.span("traced"):
            pass
    assert calls == ["warn", 0] and ranges == ["mink.on"]
    assert [r.spans[0].name for r in profiling.records()] == ["on"]
    assert warnings.filters == filters and warnings.showwarning is show


def test_profiler_session_records_mink_ranges_nested_as_the_records():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("train.step"):
            with profiling.span("train.forward"):
                torch.ones(4).sum()
            with profiling.span("train.backward"):
                with profiling.span("leaf"):
                    torch.ones(4).sum()
    rec, = profiling.records()
    events = [e for e in prof.events()
              if e.name.startswith(profiling.RANGE_PREFIX)]
    assert [e.name for e in events] == [
        "mink." + s.name for s in rec.spans]
    got = [(e.name[5:], e.cpu_parent.name[5:] if e.cpu_parent else None)
           for e in events]
    assert got == _shape(rec)


def _tiny_step():
    torch.manual_seed(0)
    module = torch.nn.Linear(4, 2)
    state = mp.train.TrainState(module,
                                torch.optim.Adam(module.parameters(), 1e-3))

    def loss_fn(m, batch):
        out = m(batch)
        return (out ** 2).mean(), {"peak": out.abs().max()}
    return state, mp.train.make_train_step(loss_fn)


def test_train_step_record_holds_forward_backward_and_optimizer():
    state, step = _tiny_step()
    with profiling.recording():
        step(state, torch.randn(8, 4))
    rec, = profiling.records()
    assert _shape(rec) == [("train.step", None),
                           ("train.forward", "train.step"),
                           ("train.backward", "train.step"),
                           ("train.optimizer", "train.step")]
    top, fwd, bwd, opt = rec.spans
    assert fwd.end_ns <= bwd.start_ns and bwd.end_ns <= opt.start_ns
    assert fwd.ms + bwd.ms + opt.ms <= top.ms
    step(state, torch.randn(8, 4))  # recording off: no record
    assert len(profiling.records()) == 1


def test_generation_request_record_holds_encode_steps_and_decode():
    b, cap, res = 2, 256, 16
    rng = np.random.RandomState(0)
    vox = [np.unique(rng.randint(0, res, (40, 3)), axis=0) for _ in range(b)]
    cpad, valid = mp.ops.pad_to_capacity(mp.ops.batched_coordinates_np(vox),
                                         cap)
    vae = mp.models.VAE(channels=(8, 12, 16, 16, 4),
                        encoder_capacities=(128, 64, 32, 32, 32),
                        decoder_capacities=(32, 64, 128, 256), device="cpu",
                        seed=0)
    unet = mp.models.UNet(channels=(4, 8, 16, 16), attn_max_len=32, group=4,
                          down_capacities=(16, 8, 8), device="cpu", seed=1)
    fn = mp.serve.build_generate_fn(
        vae, unet, mp.diffusion.DDIMScheduler.create(), input_capacity=cap,
        batch_size=b, resolution=res, sample_steps=2, device="cpu")
    with profiling.recording():
        fn(cpad, valid, generator=torch.Generator().manual_seed(0))
    rec, = profiling.records()
    top = ("serve.generate", None)
    step = [("sample.step", "serve.generate"),
            ("unet.forward", "sample.step"),
            ("scheduler.step", "sample.step")]
    assert _shape(rec) == [top, ("serve.encode", "serve.generate")] + \
        step * 2 + [("serve.decode", "serve.generate")]
    assert rec.counter("sync") == 0  # no card, no sync debug mode


def _warn_sync():
    warnings.warn(SYNC)  # the line each counted sync names


def test_sync_warnings_are_counted_and_named_on_the_innermost_span(
        monkeypatch):
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda message, *a, **k: shown.append(str(message)))
    with profiling.recording():
        with profiling.span("outer"):
            with profiling.span("inner"):
                for _ in range(3):  # one line, every time
                    _warn_sync()
            # the mode's notice is no sync; it and other warnings pass on
            warnings.warn("Synchronization debug mode is a prototype")
            warnings.warn("unrelated")
    assert shown == ["Synchronization debug mode is a prototype",
                     "unrelated"]
    rec, = profiling.records()
    outer, inner = rec.spans
    line = _warn_sync.__code__.co_firstlineno + 1
    assert inner.counters == {"sync": 3} and "sync" not in outer.counters
    assert inner.syncs == [f"tests/test_torch_profiling.py:{line}"] * 3
    assert rec.counter("sync") == 3
    with profiling.span("off"):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            _warn_sync()  # off: shown as any warning, counted nowhere
    assert len(seen) == 1 and len(profiling.records()) == 1


def _grids():
    rng = np.random.RandomState(0)
    rows = [np.concatenate([np.full((len(c), 1), b, np.int32), c], 1)
            for b, c in enumerate(np.unique(rng.randint(0, 8, (90, 3)),
                                            axis=0) for _ in range(2))]
    cpad, valid = mp.ops.pad_to_capacity(np.concatenate(rows), 256)
    grid, _, _ = mp.ops.make_grid(torch.as_tensor(cpad),
                                  torch.as_tensor(valid), 256, 1, 2,
                                  extent=(8,) * 3)
    return grid, mp.ops.stride_grid(grid, 2, 128)


def _count_like_the_kernel(in_keys, out_coords, out_valid, offs, s_in,
                           cells):
    """What the kernel adds into the work slot: the pairs of the plain
    pair list, the valid input keys, the valid output rows."""
    starts, _, _ = fc.pair_list(in_keys, out_coords, out_valid, offs, s_in,
                                cells)
    if fc.WORK.slot is not None:
        fc.WORK.slot += torch.tensor([int(starts[-1]),
                                      int((in_keys != INT32_MAX).sum()),
                                      int(out_valid.sum())])


@pytest.mark.parametrize("kind", ["B1", "B2", "B3"])
def test_a_launch_records_the_work_of_benchmark_launch_work(kind,
                                                            monkeypatch):
    from benchmark import work

    seen = []

    def launch(features, kernel, in_keys, out_coords, out_valid, offs, s_in,
               cells, cd, transpose_weight=False, stage="full"):
        seen.append((features.shape, kernel, in_keys, out_coords, out_valid,
                     offs, s_in, cells))
        _count_like_the_kernel(in_keys, out_coords, out_valid, offs, s_in,
                               cells)
        w = kernel.transpose(1, 2) if transpose_weight else kernel
        return fc._fused_sparse_conv_plain(features, w, in_keys, out_coords,
                                           out_valid, offs, s_in, cells, cd)

    def launch_dk(features, g, in_keys, out_coords, out_valid, offs, s_in,
                  cells, cd):
        seen.append((features.shape, g.shape, in_keys, out_coords, out_valid,
                     offs, s_in, cells))
        _count_like_the_kernel(in_keys, out_coords, out_valid, offs, s_in,
                               cells)
        return fc._dkernel_plain(features, g, in_keys, out_coords, out_valid,
                                 offs, s_in, cells, cd)

    monkeypatch.setattr(fc, "_launch", launch)
    monkeypatch.setattr(fc, "_launch_dkernel", launch_dk)
    gi, go = _grids()
    spec = mp.ops.KernelSpec(3, 2, ndim=3)
    offs, s_in, cells = fc.conv_geometry(gi, spec)
    f_offs, s_out, f_cells = fc.flipped_geometry(go, offs)
    cin, cout, f32 = 5, 7, torch.float32
    feats = torch.randn(gi.capacity, cin) * gi.valid[:, None]
    kernel = torch.randn(len(offs), cin, cout)
    g = torch.randn(go.capacity, cout) * go.valid[:, None]
    flat = [int(v) for v in offs.reshape(-1)]
    wrapper = {"B1": fc.fused_sparse_conv, "B2": fc.fused_conv_dfeatures,
               "B3": fc.fused_conv_dkernel}[kind]
    before = wrapper.launches
    with profiling.recording(), profiling.span("conv"):
        if kind == "B1":
            library._fused_cuda(feats, kernel, gi.flat_keys(), gi.coords,
                                gi.valid, go.flat_keys(), go.coords,
                                go.valid, flat, list(s_in), list(gi.extent),
                                list(go.stride), list(go.extent), f32)
        elif kind == "B2":
            library._dfeatures_cuda(g, kernel, go.flat_keys(), gi.coords,
                                    gi.valid, [int(v) for v in
                                               f_offs.reshape(-1)],
                                    list(s_out), f_cells, f32)
        else:
            library._dkernel_cuda(feats, g, gi.flat_keys(), go.coords,
                                  go.valid, flat, list(s_in), cells, f32)
        assert fc.WORK.slot is None  # set around the launch only
    assert wrapper.launches == before + 1
    rec, = profiling.records()
    assert rec.spans[0].counters == {"fused_conv." + kind: 1}
    launch_, = rec.launches
    assert launch_.kind == kind and launch_.pairs > 0
    ops, moved = work.launch_work(kind, *seen[0])
    assert (launch_.ops, launch_.bytes) == (ops, moved)
