"""The UNet's forward replayed as a CUDA graph.

``UNet.forward`` hands a call to ``UNetGraphs`` where ``engages`` says a
graph can stand for the eager forward: a CUDA input on a grid with a static
extent, gradients off, nothing compiling, exporting or capturing.
Everything else runs the eager forward as it is, and so does a call while a
forward hook is set on a submodule or on every module (a replay would not
call it).

One graph is captured per input signature (``signature``: everything static
that the forward branches on, the process-wide route and precision switches
included), at most ``MAX_GRAPHS`` of them, least recently used first out,
in one memory pool of the module.  The first call of a signature copies its
inputs into the graph's own static buffers, runs the eager forward on them
once on a side stream (cuDNN, cuBLAS and the kernels' lazy set-up; its
output is that call's) and captures it with ``torch.cuda.graph`` on that
stream.  A later call copies its features, timesteps, condition and grid
(``coords`` and ``valid``: the latent coordinate set changes from request
to request) into those buffers and replays.  The static grid carries no
cached flat keys or hash table, so whatever the forward derives from the
grid is computed inside the graph on every replay, as the eager forward
does.  The output is a clone of the graph's static output on the caller's
own grid object; the caller's tensors are never aliased.

A capture that raises leaves its signature to the eager forward from then
on, and answers its call with the warm-up's output, counted as that one
eager call (nothing of the failed capture counts).  A capture that failed
on the device (a sync, an illegal call) leaves the allocator recording into
its pool and the CUDA generators in capture mode: ``torch.cuda.graph`` ends
both only after a clean capture.  So later graphs take a new pool, and an
empty capture ends the generators' capture mode.  Each call runs the
forward once, eager or replayed, and counts as one.  The graph reads the
parameters and buffers in place: ``load_state_dict`` and an optimizer's
step are seen by the next replay, and a graph whose parameters or buffers
moved to other storage (``.to``, ``.half``, ``train.optim.cast_params``) is
captured anew.  A parameter replaced by another object on a submodule is
not seen.

What the Python of the forward counts, a replay counts too, as the launches
it makes: the wrappers' ``.launches`` (``ops.library.launch_counters``) by
the graph's launches, the fused conv launches with their work on an open
profiling record (``utils.profiling.capturing``, ``count_replay``), the
routes and attention calls of an open ``nn.record_routes`` /
``nn.record_attention``.  The capture itself launches nothing and counts
nothing.  Counters on the innermost profiling span: ``unet.graph_replay`` a
replay, ``unet.graph_capture`` a capture, ``unet.graph_fallback`` a failed
one.
"""

from __future__ import annotations

import collections
import warnings
from typing import Callable, Optional

import torch

from ..nn import attention as _attention
from ..nn import conv as _conv
from ..ops import conv as _ops_conv
from ..ops import dense_conv as _dense
from ..ops import lut as _lut
from ..ops import onehot_conv as _onehot
from ..ops import vol_conv as _vol
from ..ops.coords import SparseGrid
from ..ops.library import launch_counters
from ..tensor import SparseTensor
from ..utils import profiling

MAX_GRAPHS = 4  # signatures a UNet keeps a graph of
# the side stream of each device that warms up and captures every graph:
# one stream, so one cuBLAS workspace (32 MiB on the H100) for them all
_STREAMS: dict = {}


def _tracing() -> bool:
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def engages(x: SparseTensor, timesteps) -> bool:
    """Whether a call of the UNet on ``x`` is one a graph could stand for:
    plain CUDA tensors (no tracer's), a grid with a static extent,
    gradients off, and nothing compiling, exporting or capturing."""
    return (type(x.features) is torch.Tensor and x.features.is_cuda
            and isinstance(timesteps, torch.Tensor)
            and x.grid.extent is not None
            and not torch.is_grad_enabled() and not _tracing()
            and not torch.cuda.is_current_stream_capturing())


def switches() -> tuple:
    """The process-wide switches the forward's convs and matmuls read at
    call time: the compute dtype (``ops.set_default_compute_dtype``), the
    brick, dense and one-hot routes (``enable_brick_conv``,
    ``enable_dense_conv``, ``enable_dense_no_growth``,
    ``use_onehot_conv``), ``config.set_algorithm``'s LUT ceiling and fused
    gather threshold, and torch's float32 matmul and cuDNN precision."""
    return (_ops_conv._DEFAULT_COMPUTE_DTYPE, _vol._BRICK_ENABLED,
            _dense.DENSE_CONV_ENABLED, _dense.DENSE_NO_GROWTH,
            _onehot._ENABLED, _lut.LUT_MAX_ENTRIES,
            _ops_conv.DEFAULT_FUSED_THRESHOLD,
            torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)


def signature(x: SparseTensor, timesteps: torch.Tensor,
              encoder_hidden_state: Optional[torch.Tensor]) -> tuple:
    """Everything static that the forward branches on: the grid's
    capacity, stride, batch size and extent, the features' dtype and
    width, the timesteps' shape and dtype, the condition's shape (or
    none), the devices, whether inference mode is on, and ``switches``."""
    g, f, ehs = x.grid, x.features, encoder_hidden_state
    return (f.device, tuple(g.coords.shape), tuple(g.stride), g.batch_size,
            tuple(g.extent), f.dtype, tuple(f.shape), tuple(timesteps.shape),
            timesteps.dtype, timesteps.device,
            None if ehs is None else (tuple(ehs.shape), ehs.dtype,
                                      ehs.device),
            torch.is_inference_mode_enabled()) + switches()


def _storage(tensors) -> list:
    return [t.data_ptr() for t in tensors]


class _Graph:
    """One signature's graph: its static inputs, its static output, what
    the capture counted (``launches``: (wrapper, launches a replay) pairs;
    ``work``: the fused conv launches with their work slots; ``routes``,
    ``attention``: the conv and attention records), and the module's
    parameters and buffers (``tensors``) with the storage it read them
    from."""

    def __init__(self, x: SparseTensor, timesteps: torch.Tensor,
                 ehs: Optional[torch.Tensor]):
        g = x.grid
        self.coords = torch.empty_like(g.coords)
        self.valid = torch.empty_like(g.valid)
        self.features = torch.empty_like(x.features)
        self.timesteps = torch.empty_like(timesteps)
        self.ehs = None if ehs is None else torch.empty_like(ehs)
        self.geometry = (g.stride, g.batch_size, g.extent)
        self.load(x, timesteps, ehs)
        self.graph = torch.cuda.CUDAGraph()
        self.out: Optional[torch.Tensor] = None
        self.launches: list = []
        self.work: Optional[profiling.Record] = None
        self.routes: list = []
        self.attention: list = []
        self.tensors: list = []
        self.storage: list = []

    def load(self, x: SparseTensor, timesteps: torch.Tensor,
             ehs: Optional[torch.Tensor]) -> None:
        self.coords.copy_(x.grid.coords)
        self.valid.copy_(x.grid.valid)
        self.features.copy_(x.features)
        self.timesteps.copy_(timesteps)
        if ehs is not None:
            self.ehs.copy_(ehs)

    def inputs(self) -> tuple:
        """The static inputs on a new grid object, with nothing derived
        from its coordinates cached on it."""
        stride, batch_size, extent = self.geometry
        grid = SparseGrid(self.coords, self.valid, stride, batch_size,
                          extent)
        return (SparseTensor(grid=grid, features=self.features),
                self.timesteps, self.ehs)


class UNetGraphs:
    """The graphs of one UNet, by signature (see the module's docstring).
    Not copied with the module: a copy starts with none."""

    def __init__(self):
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.pool = None
        self.submodules: Optional[list] = None  # the UNet's, but itself

    def __deepcopy__(self, memo):
        return UNetGraphs()

    def __getstate__(self):
        return {}

    def __setstate__(self, state):
        self.__init__()

    def __call__(self, module: torch.nn.Module, forward: Callable,
                 x: SparseTensor, timesteps: torch.Tensor,
                 ehs: Optional[torch.Tensor]) -> SparseTensor:
        if self.hooked(module):
            return forward(x, timesteps, ehs)
        key = (module.training,) + signature(x, timesteps, ehs)
        graph = self.graphs.get(key, False)
        if graph and graph.storage != _storage(graph.tensors):
            graph = False  # the parameters moved: capture anew
        if graph is False:
            graph, out = self._capture(module, forward, x, timesteps, ehs)
            self.graphs[key] = graph
            while len(self.graphs) > MAX_GRAPHS:
                self.graphs.popitem(last=False)
            return SparseTensor(grid=x.grid, features=out)
        self.graphs.move_to_end(key)
        if graph is None:
            return forward(x, timesteps, ehs)
        graph.load(x, timesteps, ehs)
        graph.graph.replay()
        _replayed(graph)
        return SparseTensor(grid=x.grid, features=graph.out.clone())

    def hooked(self, module: torch.nn.Module) -> bool:
        """Whether a forward hook would fire inside the module's forward:
        on one of its submodules (listed at the first call), or on every
        module."""
        if self.submodules is None:
            self.submodules = [m for m in module.modules() if m is not module]
        hooks = torch.nn.modules.module
        return bool(hooks._global_forward_hooks or
                    hooks._global_forward_pre_hooks or
                    any(m._forward_hooks or m._forward_pre_hooks
                        for m in self.submodules))

    def _capture(self, module, forward, x, timesteps, ehs) -> tuple:
        """(the graph, or None where its capture failed; the features of
        the eager forward on the static inputs, this call's output)."""
        dev = x.features.device
        graph = _Graph(x, timesteps, ehs)
        side = _STREAMS.get(dev)
        if side is None:
            side = _STREAMS[dev] = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            first = forward(*graph.inputs()).features
        current.wait_stream(side)
        first.record_stream(current)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        counters = launch_counters()
        before = [c.launches for c in counters]
        try:
            with _conv.record_routes() as routes, \
                    _attention.record_attention() as attention:
                x_in, t_in, ehs_in = graph.inputs()
                with torch.cuda.graph(graph.graph, pool=self.pool,
                                      stream=side,
                                      capture_error_mode="thread_local"):
                    with profiling.capturing(dev) as work:
                        out = forward(x_in, t_in, ehs_in)
            if out.grid is not x_in.grid:
                raise RuntimeError("the output lies on another grid than "
                                   "the input")
        except Exception as e:  # noqa: BLE001 - any failure runs eager
            warnings.warn(f"the UNet's forward could not be captured as a "
                          f"CUDA graph and runs eager for this input "
                          f"signature: {e!r}")
            profiling.count("unet.graph_fallback")
            self.pool = None  # it may be left recording the failed capture
            _end_capture_mode(side)
            return None, first
        finally:
            # a capture that failed on the device leaves torch.cuda.graph
            # without restoring the stream it replaced
            torch.cuda.set_stream(current)
            graph.launches = [(c, c.launches - b)
                              for c, b in zip(counters, before)
                              if c.launches != b]
            for c, b in zip(counters, before):
                c.launches = b  # a capture launches nothing
        graph.out, graph.work = out.features, work
        graph.routes, graph.attention = list(routes), list(attention)
        graph.tensors = list(module.parameters()) + list(module.buffers())
        graph.storage = _storage(graph.tensors)
        profiling.count("unet.graph_capture")
        return graph, first


def _end_capture_mode(side) -> None:
    """End the CUDA generators' capture mode, which a capture that failed
    on the device leaves on, by an empty capture in a pool of its own
    (a clean end ends it; after a capture that failed on the host, which
    ended cleanly, it changes nothing)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*CUDA Graph is empty")
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            pass


def _replayed(graph: _Graph) -> None:
    """Count what the replay launched, as the eager forward's Python
    counts it."""
    profiling.count("unet.graph_replay")
    for counter, n in graph.launches:
        counter.launches += n
    profiling.count_replay(graph.work)
    if _conv._ROUTES is not None:
        _conv._ROUTES.extend(graph.routes)
    if _attention._ROUTES is not None:
        _attention._ROUTES.extend(graph.attention)
