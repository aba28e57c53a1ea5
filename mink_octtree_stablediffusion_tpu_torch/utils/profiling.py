"""Profiling and timing helpers.

Port of `mink_octtree_stablediffusion_tpu/utils/profiling.py`: a `Timer`
with min/max/avg reporting (the reference's `examples/common.py:32-60`),
`trace`, a context manager around ``torch.profiler`` that writes a Chrome
trace, and `synced_time`, the seconds per call of a function with the
device synchronized around the timed calls.

The port's own recorder of spans and counters, at its layer boundaries
(the train step's forward, backward and optimizer, the DDIM step's UNet
and scheduler, serving's encode and decode, the fused conv's launches):

- ``span(name)``: a context manager.  A span opened with no span open
  around it on its thread is top-level, and its closing closes a
  ``Record``: the top-level span, its nested spans (name, start and end on
  ``time.perf_counter_ns()``, parent) and their counters.  The last
  ``MAX_RECORDS`` records are kept; ``records()`` returns them.
- ``count(name, n)``: adds to a counter of the innermost open span.  The
  stack of open spans is kept per thread; a thread with no span open
  counts on the innermost span of the one thread that has a record open,
  if there is exactly one: PyTorch's autograd engine runs a backward's
  functions (B2 and B3 among them) on threads of its own while the thread
  that called ``backward()`` waits for them.
- Recording is on inside ``recording()`` or while a ``torch.profiler``
  session records, checked when a top-level span opens.  Off, a span
  costs a flag check: no ``record_function``, no device memory, no global
  mode touched, and nothing in a graph that ``torch.export`` or a fake
  tensor mode traces.  On, each span also opens
  ``torch.profiler.record_function("mink.<name>")``, so it lies on the
  clock of the kernels in a profiler trace (``trace``'s Chrome trace).
- While a record is open, ``torch.cuda``'s sync debug mode is "warn", and
  each "synchronizing CUDA operation" warning is counted as ``sync`` on the
  innermost span of the thread that synced, with its file:line
  (``Span.syncs``).  The mode is restored when the last open record
  closes.
- The fused conv's launches (B1, B2, B3) are counted as
  ``fused_conv.<kind>`` with their work (``Launch``): the host knows each
  launch's widths and weight bytes; the kernel adds its matched pairs and
  the valid rows it reads and writes into a slot of the record's device
  buffer (``work_slot``), read once, by ``records()``, after the record
  has closed.
- A CUDA graph's launches (``capturing``, ``count_replay``): while a
  graph is captured, the fused conv launches count nothing on a span and
  are kept in a ``Record`` of the graph's, their work slots rows of
  buffers the graph owns and zeroes as its first node; each replay inside
  an open record counts them on the innermost span as launches, with
  their work copied from the graph's slots into the record's.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class Timer:
    """Wall-clock timer with running stats."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.calls = 0
        self.min = float("inf")
        self.max = 0.0
        self._t0: Optional[float] = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.calls += 1
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)
        return dt

    @property
    def avg(self) -> float:
        return self.total / max(self.calls, 1)

    def __str__(self):
        return (f"Timer(calls={self.calls}, avg={self.avg:.4f}s, "
                f"min={self.min:.4f}s, max={self.max:.4f}s)")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the CPU, and CUDA where there is
    a card); writes ``<logdir>/trace.json`` (Chrome's trace format) and
    yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def synced_time(fn, *args, iters: int = 10, warmup: int = 1, **kw) -> float:
    """Mean seconds per call of ``fn(*args, **kw)`` over ``iters`` calls
    after ``warmup``, the device synchronized before and after."""
    for _ in range(warmup):
        fn(*args, **kw)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kw)
    _sync()
    return (time.perf_counter() - t0) / iters


# -- the recorder -------------------------------------------------------------

MAX_RECORDS = 64
RANGE_PREFIX = "mink."
_SLOTS_PER_CHUNK = 512  # launches a device buffer of work slots holds
_SLOT_WORDS = 3  # int64 a slot: matched pairs, valid rows read, rows written
_PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_DIR = os.path.dirname(_PORT_DIR)


@dataclass
class Span:
    """A closed span: ``parent`` is the index of the enclosing span in its
    record (None for the top-level span); ``syncs`` the file:line of each
    sync counted on it (``counters["sync"]``)."""
    name: str
    start_ns: int = 0
    end_ns: int = 0
    parent: Optional[int] = None
    counters: Dict[str, int] = field(default_factory=dict)
    syncs: List[str] = field(default_factory=list)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclass
class Launch:
    """One launch of a fused conv kernel (``kind`` B1, B2 or B3) inside span
    ``span`` of its record: its widths (Cin of the operand it reads, Cout of
    what it writes), offsets ``k``, the weight's bytes (read by B1/B2, dW
    written by B3) and coordinate columns, and what the kernel counted:
    matched (output row, offset) pairs and the valid rows it reads and
    writes."""
    kind: str
    cin: int
    cout: int
    k: int
    weight_bytes: int
    coord_cols: int
    span: int
    pairs: int = 0
    rows_in: int = 0
    rows_out: int = 0
    slot: Optional[torch.Tensor] = field(default=None, repr=False)

    @property
    def ops(self) -> int:
        """2·Cin·Cout a matched pair."""
        return 2 * self.cin * self.cout * self.pairs

    @property
    def bytes(self) -> int:
        """Each valid input row (its features and key) read once, each
        valid output row (its features and coordinates) written or read
        once, and the weight once, at 4 bytes a value."""
        return ((self.rows_in * self.cin + self.rows_out * self.cout) * 4
                + self.weight_bytes + self.rows_in * 4
                + self.rows_out * 4 * self.coord_cols)


class Record:
    """A closed top-level span with its nested spans (``spans[0]`` the
    top-level one, the others in the order they opened) and the fused conv
    launches made inside it."""

    def __init__(self):
        self.spans: List[Span] = []
        self.launches: List[Launch] = []
        self._chunks: List[torch.Tensor] = []
        self._used = 0

    def within(self, i: int) -> List[int]:
        """Indices of span ``i`` and of every span nested in it."""
        inside = {i}
        for j in range(i + 1, len(self.spans)):
            if self.spans[j].parent in inside:
                inside.add(j)
        return sorted(inside)

    def counter(self, name: str, i: int = 0) -> int:
        """Counter ``name`` summed over span ``i`` and the spans in it."""
        return sum(self.spans[j].counters.get(name, 0)
                   for j in self.within(i))

    def _slots(self, device, n: int = 1) -> torch.Tensor:
        """``n`` zeroed work slots in a row of one of the record's buffers
        (a chunk of at least ``_SLOTS_PER_CHUNK``)."""
        last = self._chunks[-1] if self._chunks else None
        if (last is None or self._used + n > last.shape[0] or
                last.device != torch.device(device)):
            self._chunks.append(torch.zeros(
                (max(_SLOTS_PER_CHUNK, n), _SLOT_WORDS), dtype=torch.int64,
                device=device))
            self._used = 0
        self._used += n
        return self._chunks[-1][self._used - n:self._used]

    def _resolve(self) -> None:
        """Read the kernels' work slots (once: one copy a buffer)."""
        if not self._chunks:
            return
        words = {}
        for c in self._chunks:
            base = c.data_ptr()
            for r, row in enumerate(c.tolist()):
                words[base + r * _SLOT_WORDS * 8] = row
        for launch in self.launches:
            if launch.slot is not None:
                launch.pairs, launch.rows_in, launch.rows_out = words[
                    launch.slot.data_ptr()]
                launch.slot = None
        self._chunks = []


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []  # (record, span index) of the open spans
        self.graph: Optional[Record] = None  # a graph's, captured now


_local = _Local()
_open: Dict[int, list] = {}  # thread ident → its stack, a record open
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_lock = threading.Lock()
_forced = 0  # open ``recording()`` blocks
# open records; the warnings state and sync debug mode they replaced
_watch = {"open": 0, "saved": None}


@contextlib.contextmanager
def recording():
    """Record spans inside the block (also with no profiler session)."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


class _Span:
    __slots__ = ("name", "record", "index", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.stack
        if stack:
            rec, parent = stack[-1]
        else:
            rec, parent = Record(), None
            _watch_syncs(1)
            _open[threading.get_ident()] = stack
        self.record, self.index = rec, len(rec.spans)
        span_ = Span(self.name, parent=parent)
        rec.spans.append(span_)
        self.range = torch.profiler.record_function(RANGE_PREFIX + self.name)
        self.range.__enter__()
        stack.append((rec, self.index))
        span_.start_ns = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.record.spans[self.index].end_ns = time.perf_counter_ns()
        _local.stack.pop()
        self.range.__exit__(*exc)
        if self.index == 0:
            _open.pop(threading.get_ident(), None)
            with _lock:
                _records.append(self.record)
            _watch_syncs(-1)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A span named ``name`` over the block (see the module's docstring);
    off, a shared no-op context.  Recording is on inside an open record, or
    for a top-level span inside ``recording()`` or a profiler session, and
    never while ``torch.export`` or ``torch.compile`` traces."""
    if (_local.stack or _forced or _autograd_profiler._is_profiler_enabled) \
            and not torch.compiler.is_compiling():
        return _Span(name)
    return _OFF


def _innermost():
    """(record, span index) that this thread counts on, or None: its own
    innermost open span, else that of the one thread with a record open."""
    stack = _local.stack
    if not stack:
        if not _open:
            return None
        stacks = list(_open.values())
        if len(stacks) != 1:
            return None
        stack = stacks[0]
    try:
        return stack[-1]
    except IndexError:  # that record closed meanwhile
        return None


def _add(at, name: str, n: int = 1) -> Span:
    span_ = at[0].spans[at[1]]
    span_.counters[name] = span_.counters.get(name, 0) + n
    return span_


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span, if any."""
    at = _innermost()
    if at is not None:
        _add(at, name, n)


def work_slot(device) -> Optional[torch.Tensor]:
    """A zeroed int64 [3] slot on ``device`` in the open record's buffer,
    into which a fused conv kernel adds its matched pairs, valid rows read
    and valid rows written; None when no record is open.  While this
    thread captures a graph (``capturing``), a slot of the graph's."""
    at = _innermost() if _local.graph is None else (_local.graph, None)
    return None if at is None else at[0]._slots(device)[0]


def count_launch(kind: str, slot: Optional[torch.Tensor], *, cin: int,
                 cout: int, k: int, weight_bytes: int,
                 coord_cols: int) -> None:
    """Count a fused conv launch as ``fused_conv.<kind>`` on the innermost
    open span and keep its work (``Launch``), if a record is open; while
    this thread captures a graph, keep it as the graph's instead (a
    capture launches nothing)."""
    if _local.graph is not None:
        _local.graph.launches.append(Launch(
            kind, cin, cout, k, weight_bytes, coord_cols, -1, slot=slot))
        return
    at = _innermost()
    if at is not None:
        _add(at, "fused_conv." + kind)
        at[0].launches.append(Launch(kind, cin, cout, k, weight_bytes,
                                     coord_cols, at[1], slot=slot))


@contextlib.contextmanager
def capturing(device):
    """Inside a CUDA graph's capture: the fused conv launches of the block
    are kept in the graph's ``Record`` (yielded; no span, its launches'
    ``span`` -1), not counted.  Its first work buffer is made and zeroed
    here, so that zeroing it is the graph's first node when the block opens
    the capture."""
    graph = Record()
    graph._slots(device, 0)
    prev, _local.graph = _local.graph, graph
    try:
        yield graph
    finally:
        _local.graph = prev


def count_replay(graph: Record) -> None:
    """Count a replay of a graph (its ``capturing`` record) on the
    innermost open span, if a record is open: each of its launches as
    ``fused_conv.<kind>`` with its work, copied from the graph's slots into
    the record's (a device copy a buffer of the graph's)."""
    at = _innermost()
    if at is None or not graph.launches:
        return
    rec, n = at[0], len(graph.launches)
    rows, done = rec._slots(graph._chunks[0].device, n), 0
    for buf in graph._chunks:
        take = min(n - done, buf.shape[0])
        rows[done:done + take].copy_(buf[:take])
        done += take
    for launch, row in zip(graph.launches, rows):
        _add(at, "fused_conv." + launch.kind)
        rec.launches.append(dataclasses.replace(launch, span=at[1],
                                                slot=row))


def records() -> List[Record]:
    """The closed records, oldest first, their launches' work read from
    the device (a copy a buffer, once a record)."""
    with _lock:
        out = list(_records)
    for rec in out:
        rec._resolve()
    return out


def clear_records() -> None:
    with _lock:
        _records.clear()


# -- syncs --------------------------------------------------------------------


def _watch_syncs(delta: int) -> None:
    """Opening the first record: the sync debug mode to "warn" and its
    warnings to ``_on_warning``; closing the last: both restored."""
    with _lock:
        _watch["open"] += delta
        if delta > 0 and _watch["open"] == 1:
            mode = None
            if torch.cuda.is_available():
                mode = torch.cuda.get_sync_debug_mode()
            saved = warnings.catch_warnings()
            saved.__enter__()
            _watch["saved"] = (saved, mode, warnings.showwarning)
            # every sync warned, also from a line that warned before
            warnings.filterwarnings("always", message=".*synchroniz")
            warnings.showwarning = _on_warning
            if mode is not None:
                torch.cuda.set_sync_debug_mode("warn")
        elif delta < 0 and _watch["open"] == 0:
            saved, mode, _ = _watch["saved"]
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
            saved.__exit__(None, None, None)
            _watch["saved"] = None


def _is_sync(message) -> bool:
    """A "synchronizing CUDA operation" warning of the sync debug mode (not
    the mode's notice that it is a prototype)."""
    text = str(message)
    return "synchroniz" in text.lower() and "prototype" not in text


def _where(filename: str, lineno: int) -> str:
    path = os.path.abspath(filename)
    if path.startswith(_REPO_DIR + os.sep):
        path = os.path.relpath(path, _REPO_DIR)
    elif "site-packages" + os.sep in path:
        path = path.split("site-packages" + os.sep, 1)[1]
    return f"{path}:{lineno}"


def _port_frame() -> Optional[str]:
    """file:line of the innermost frame of the port's own code."""
    f = sys._getframe(1)
    here = os.path.abspath(__file__)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PORT_DIR + os.sep) and path != here:
            return _where(path, f.f_lineno)
        f = f.f_back
    return None


def _on_warning(message, category, filename, lineno, file=None, line=None):
    saved = _watch["saved"]
    if not _is_sync(message):
        show = saved[2] if saved else warnings._showwarning_orig
        return show(message, category, filename, lineno, file, line)
    at = _innermost()
    if at is None:
        return None  # no record to count it on
    where = _where(filename, lineno)
    if not os.path.abspath(filename).startswith(_PORT_DIR + os.sep):
        inner = _port_frame()
        if inner is not None:
            where += " < " + inner
    _add(at, "sync").syncs.append(where)
    return None
