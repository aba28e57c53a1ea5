"""The UNet's CUDA graph runner (``models/unet_graph.py``) on the CPU, where
no graph is captured or replayed: a generation request on the CPU and a
forward with gradients on count no capture, replay or fallback and keep no
graph (the export: ``tests/test_torch_serve.py``); a hook inside the UNet
keeps it eager; the signature separates what the forward branches on, the
process-wide switches included, and nothing else; what a replay counts (the
wrappers' launches, the fused conv launches with their work on an open
record, the conv and attention routes) is what the eager forward's launches
count; and every wrapper that counts launches is one a replay advances (no
JAX).  The card tests hold the graphed
forward to the eager one (``tests/test_torch_cuda.py``).
"""

import copy
import pickle

import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch import ops
from mink_octtree_stablediffusion_tpu_torch.models import unet_graph
from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv as fc
from mink_octtree_stablediffusion_tpu_torch.utils import profiling

B, CAP, RES = 2, 256, 16
COUNTERS = ("unet.graph_replay", "unet.graph_capture", "unet.graph_fallback")


@pytest.fixture(autouse=True)
def _fresh_records():
    profiling.clear_records()
    yield
    profiling.clear_records()


def _models():
    vae = mp.models.VAE(channels=(8, 12, 16, 16, 4),
                        encoder_capacities=(128, 64, 32, 32, 32),
                        decoder_capacities=(32, 64, 128, 256), device="cpu",
                        seed=0)
    unet = mp.models.UNet(channels=(4, 8, 16, 16), attn_max_len=32, group=4,
                          down_capacities=(16, 8, 8), device="cpu", seed=1)
    return vae, unet


def _request():
    rng = np.random.RandomState(0)
    vox = [np.unique(rng.randint(0, RES, (40, 3)), axis=0) for _ in range(B)]
    return mp.ops.pad_to_capacity(mp.ops.batched_coordinates_np(vox), CAP)


def _fn(vae, unet, steps=2):
    return mp.serve.build_generate_fn(
        vae, unet, mp.diffusion.DDIMScheduler.create(), input_capacity=CAP,
        batch_size=B, resolution=RES, sample_steps=steps, device="cpu")


def _latent(unet, seed=0, batch=B, extent=(RES,) * 3):
    rng = np.random.RandomState(seed)
    vox = [np.unique(rng.randint(0, RES, (30, 3)), axis=0) * 8
           for _ in range(batch)]
    cpad, valid = mp.ops.pad_to_capacity(mp.ops.batched_coordinates_np(vox),
                                         64)
    grid, _, _ = mp.ops.make_grid(torch.as_tensor(cpad),
                                  torch.as_tensor(valid), 64, 8, batch,
                                  extent=None if extent is None else
                                  tuple(e * 8 for e in extent))
    feats = torch.randn(64, unet.channels[0],
                        generator=torch.Generator().manual_seed(seed))
    return mp.SparseTensor(grid=grid, features=feats * grid.valid[:, None])


def _counted(rec):
    return {name: rec.counter(name) for name in COUNTERS}


def test_cpu_request_captures_and_replays_nothing():
    vae, unet = _models()
    cpad, valid = _request()
    with profiling.recording():
        _fn(vae, unet)(cpad, valid, generator=torch.Generator().manual_seed(0))
    rec, = profiling.records()
    assert _counted(rec) == dict.fromkeys(COUNTERS, 0)
    assert len(unet.graphs.graphs) == 0
    x = _latent(unet)
    t = torch.full((B,), 500, dtype=torch.int32)
    with torch.no_grad():
        assert not unet_graph.engages(x, t)  # the device


def test_gradients_on_or_an_unbounded_grid_run_eager():
    _, unet = _models()
    x = _latent(unet)
    t = torch.full((B,), 10, dtype=torch.int32)
    assert not unet_graph.engages(x, t)  # gradients on
    with torch.no_grad():
        assert not unet_graph.engages(_latent(unet, extent=None), t)
        assert not unet_graph.engages(x, 10)  # a timestep not a tensor
    with profiling.recording(), profiling.span("unet.forward"):
        out = unet(x, t)
    out.features.sum().backward()
    rec, = profiling.records()
    assert _counted(rec) == dict.fromkeys(COUNTERS, 0)
    assert len(unet.graphs.graphs) == 0 and out.grid is x.grid


def test_signature_separates_what_the_forward_branches_on():
    _, unet = _models()
    x, t = _latent(unet, seed=0), torch.full((B,), 7, dtype=torch.int32)
    ehs = torch.zeros(B, 3, 16)
    key = unet_graph.signature(x, t, None)
    # other coordinates, features and timestep values: one signature
    y = _latent(unet, seed=1)
    assert not torch.equal(x.grid.coords, y.grid.coords)
    assert unet_graph.signature(y, t * 3, None) == key
    grid = x.grid
    others = [
        (x.replace(grid=mp.ops.coords.SparseGrid(
            grid.coords[:32], grid.valid[:32], grid.stride, B,
            grid.extent), features=x.features[:32]), t, None),
        (x.replace(grid=mp.ops.coords.SparseGrid(
            grid.coords, grid.valid, (16, 16, 16), B, grid.extent)), t,
         None),
        (x.replace(grid=mp.ops.coords.SparseGrid(
            grid.coords, grid.valid, grid.stride, B + 1, grid.extent)), t,
         None),
        (x.replace(grid=mp.ops.coords.SparseGrid(
            grid.coords, grid.valid, grid.stride, B, (256,) * 3)), t, None),
        (x.replace(features=x.features.double()), t, None),
        (x.replace(features=torch.zeros(64, 8)), t, None),
        (x, t.long(), None), (x, t[:1], None),
        (x, t, ehs), (x, t, ehs[:, :2])]
    keys = [unet_graph.signature(*a) for a in others]
    with torch.inference_mode():
        keys.append(unet_graph.signature(x, t, None))
    # the process-wide switches the convs read at call time, each flipped
    flips = [
        (ops.set_default_compute_dtype, ops.conv._DEFAULT_COMPUTE_DTYPE,
         torch.float32),
        (ops.vol_conv.enable_brick_conv, ops.vol_conv._BRICK_ENABLED,
         not ops.vol_conv._BRICK_ENABLED),
        (ops.dense_conv.enable_dense_conv, ops.dense_conv.DENSE_CONV_ENABLED,
         not ops.dense_conv.DENSE_CONV_ENABLED),
        (ops.dense_conv.enable_dense_no_growth,
         ops.dense_conv.DENSE_NO_GROWTH, not ops.dense_conv.DENSE_NO_GROWTH),
        (ops.onehot_conv.use_onehot_conv, ops.onehot_conv._ENABLED, False),
        (torch.set_float32_matmul_precision,
         torch.get_float32_matmul_precision(), "medium"),
        (lambda v: setattr(torch.backends.cudnn, "allow_tf32", v),
         torch.backends.cudnn.allow_tf32,
         not torch.backends.cudnn.allow_tf32)]
    for setter, was, flipped in flips:
        setter(flipped)
        try:
            keys.append(unet_graph.signature(x, t, None))
        finally:
            setter(was)
    for mode in ("memory", "speed"):
        mp.config.set_algorithm(mode)
        try:
            keys.append(unet_graph.signature(x, t, None))
        finally:
            mp.config.set_algorithm("default")
    assert key not in keys and len(set(keys)) == len(keys)
    assert unet_graph.signature(x, t, None) == key  # each switch restored


def test_a_hook_inside_the_unet_keeps_it_eager():
    """A forward hook that a replay would not call: one on a submodule or
    on every module; the UNet's own hook fires around the forward and
    does not count."""
    _, unet = _models()
    hooked = unet.graphs.hooked
    assert not hooked(unet)
    handle = unet.register_forward_hook(lambda *a: None)
    assert not hooked(unet)
    handle.remove()
    for register in (unet.time_embedding.register_forward_hook,
                     unet.time_embedding.register_forward_pre_hook,
                     torch.nn.modules.module.register_module_forward_hook,
                     torch.nn.modules.module
                     .register_module_forward_pre_hook):
        handle = register(lambda *a: None)
        try:
            assert hooked(unet)
        finally:
            handle.remove()
    assert not hooked(unet)
    assert len(unet.graphs.submodules) == len(list(unet.modules())) - 1


def test_a_replay_counts_what_the_graph_launched():
    """A replay inside an open record counts the graph's fused conv
    launches as launches, on the innermost span, with the work the graph's
    kernels added into its own slots; the wrappers' ``.launches``, the
    route and attention records advance as for the eager forward's
    launches; a capture itself counts nothing."""
    before = fc.fused_sparse_conv.launches
    with profiling.recording(), profiling.span("outer"):
        with profiling.capturing("cpu") as work:
            for pairs in (5, 7):
                slot = profiling.work_slot("cpu")
                profiling.count_launch("B1", slot, cin=4, cout=8, k=27,
                                       weight_bytes=3456, coord_cols=4)
                slot += torch.tensor([pairs, 10, 11])  # as the kernel adds
    rec, = profiling.records()
    assert rec.launches == [] and rec.spans[0].counters == {}
    assert len(work.launches) == 2 and work._chunks[0].shape[0] >= 2
    graph = unet_graph._Graph.__new__(unet_graph._Graph)
    route = mp.nn.conv.Route("k3s1", "fused", 64, 4, 8, 27)
    attn = mp.nn.attention.AttentionRoute("full", 64, 8, 32)
    graph.launches, graph.work = [(fc.fused_sparse_conv, 2)], work
    graph.routes, graph.attention = [route], [attn]
    with mp.nn.record_routes() as routes, \
            mp.nn.record_attention() as attention, \
            profiling.recording():
        with profiling.span("sample.step"):
            with profiling.span("unet.forward"):
                unet_graph._replayed(graph)
                unet_graph._replayed(graph)
        unet_graph._replayed(graph)  # no record open: launches, no work
    rec = profiling.records()[-1]
    step, fwd = rec.spans
    assert fwd.counters == {"fused_conv.B1": 4, "unet.graph_replay": 2}
    assert rec.counter("unet.graph_replay", 0) == 2
    assert [(x.kind, x.span, x.pairs, x.rows_in, x.rows_out)
            for x in rec.launches] == [("B1", 1, 5, 10, 11),
                                       ("B1", 1, 7, 10, 11)] * 2
    assert rec.launches[0].ops == 2 * 4 * 8 * 5
    assert fc.fused_sparse_conv.launches == before + 6
    assert routes == [route] * 3 and attention == [attn] * 3
    fc.fused_sparse_conv.launches = before


def test_copies_of_a_unet_start_with_no_graph():
    _, unet = _models()
    unet.graphs.graphs["key"] = None
    for other in (copy.deepcopy(unet), pickle.loads(pickle.dumps(unet))):
        assert isinstance(other.graphs, unet_graph.UNetGraphs)
        assert len(other.graphs.graphs) == 0 and other.graphs.pool is None


def test_every_launch_counter_is_one_a_replay_advances():
    """``ops.library.launch_counters`` lists every wrapper in ``ops`` that
    counts its launches in ``.launches``: a wrapper left out would run
    inside a graph and its replays would not count."""
    import importlib
    import pkgutil
    found = set()
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"{ops.__name__}.{info.name}")
        found |= {id(f) for f in vars(module).values()
                  if callable(f) and type(getattr(f, "launches", None)) is int}
    listed = ops.library.launch_counters()
    assert found and {id(f) for f in listed} == found
    assert len(listed) == len(found)
