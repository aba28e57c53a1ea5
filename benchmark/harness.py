"""What every cell shares: the benchmark's files, the import guard, the
weights drawn from the seed, the clock of a window, the profiled slice
and the result line.

Nothing here imports the program under test at module level; an entry
(``benchmark/entries/<entry>.py``) imports it inside its set-up.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mink_octtree_stablediffusion_tpu")
BENCH_SPAN = "bench."


# -- files ---------------------------------------------------------------------


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_file() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration (the file's JSON under
    ``"config"``), its traffic mix and its correctness limits."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {"cell": cell, "config": load_json(ROOT, conf["file"]),
            "mix": load_json(HERE, "traffic", cell["traffic"] + ".json"),
            "limits": load_json(HERE, "limits", workload + ".json")}


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(entry: str):
    return importlib.import_module(f"benchmark.entries.{entry}")


def metric_reader(name: str):
    """``read(ctx) -> float | None`` of a per-layer metric, from
    ``benchmark/metrics/<name>.py``."""
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "benchmark_metric_" + name.replace(".", "_")).read


# -- the import guard ------------------------------------------------------------


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    each compared whole (the port's name begins with the JAX package's)."""
    names = {m.split(".")[0] for m in (modules or list(sys.modules))}
    return sorted(n for n in names if n in FORBIDDEN)


def forbidden_imports(path: str) -> List[str]:
    """Top-level names of a source file's imports that are forbidden."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module or "")
    return sorted({n for n in found if n.split(".")[0] in FORBIDDEN})


# -- weights -------------------------------------------------------------------


def draw_weights(module: torch.nn.Module, generator: torch.Generator
                 ) -> Dict[str, torch.Tensor]:
    """A state dict for ``module`` by the names and shapes of its own: every
    conv kernel [K, Cin, Cout] N(0, 2 / (K·Cin)), every dense weight [out,
    in] N(0, 1 / in), from one draw on the generator's device; the other
    entries (norm scales 1, biases 0, running statistics) as the module
    holds them."""
    sd = module.state_dict()
    drawn = [k for k, v in sd.items() if v.is_floating_point() and (
        (k.endswith("kernel") and v.dim() == 3) or
        (k.endswith("weight") and v.dim() == 2))]
    total = sum(sd[k].numel() for k in drawn)
    flat = torch.randn(total, generator=generator,
                       device=generator.device)
    out, at = {}, 0
    for k, v in sd.items():
        if k in drawn:
            fan = v.shape[0] * v.shape[1] if v.dim() == 3 else v.shape[1]
            std = math.sqrt(2.0 / fan) if v.dim() == 3 else 1.0 / math.sqrt(
                fan)
            out[k] = flat[at:at + v.numel()].view(v.shape) * std
            at += v.numel()
        else:
            out[k] = v.detach().clone()
    return out


def seeded(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


# -- the window's clock ----------------------------------------------------------


class Clock:
    """Stamps of step ends: CUDA events on the card (nothing waits for
    them), the host clock after a synchronisation elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        """The seconds from each mark to the next (the first mark opens)."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def span(name: str, record: Optional[dict] = None, device=None):
    """A ``record_function`` range named ``bench.<name>``; with ``record``
    the host seconds between synchronisations at its ends are appended to
    ``record[name]``."""
    if record is not None:
        sync(device)
        t0 = time.perf_counter()
    with torch.profiler.record_function(BENCH_SPAN + name):
        yield
    if record is not None:
        sync(device)
        record.setdefault(name, []).append(time.perf_counter() - t0)


def spanned(name: str, fn: Callable) -> Callable:
    """``fn`` inside a ``bench.<name>`` range (a few microseconds a call;
    the profiled slice's idle gaps are named by these ranges)."""
    def run(*a, **kw):
        with torch.profiler.record_function(BENCH_SPAN + name):
            return fn(*a, **kw)
    return run


def percentile(values: List[float], q: float) -> float:
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float:
    return statistics.median(values) if values else float("nan")


# -- the profiled slice -----------------------------------------------------------

# A session opens with OPEN launches of a marker kernel and closes with
# CLOSE of another (the repository's ``bench_conv.profiled`` rule): on the
# H100 ``torch.profiler`` can lose the first records of a session, which
# the opening markers take; a session that lost a closing marker is run
# again, up to TRIES times.
OPEN, CLOSE, TRIES = 1024, 64, 4
OPEN_MARKER, CLOSE_MARKER = "spin_kernel", "FillFunctor<c10::complex<float>"


def profile_slice(fn: Callable[[], None]) -> dict:
    """Run ``fn`` once inside a profiler session on the card → {"kernels":
    [(name, start_s, end_s)], "spans": [(name, start_s, end_s)] of the
    benchmark's host ranges, "window": (start_s, end_s)}, on one clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    closing = torch.zeros(1, dtype=torch.complex64, device="cuda")
    opened = closed = 0
    for _ in range(TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(OPEN):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            with torch.profiler.record_function(BENCH_SPAN + "window"):
                fn()
                torch.cuda.synchronize()
            for _ in range(CLOSE):
                closing.fill_(1.0)
            torch.cuda.synchronize()
        kernels, spans = [], []
        opened = closed = 0
        for e in prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False):
                    continue
                if OPEN_MARKER in e.name:
                    opened += 1
                elif CLOSE_MARKER in e.name:
                    closed += 1
                else:
                    kernels.append((e.name, tr.start / 1e6, tr.end / 1e6))
            elif e.name.startswith(BENCH_SPAN):
                spans.append((e.name[len(BENCH_SPAN):], tr.start / 1e6,
                              tr.end / 1e6))
        win = [s for s in spans if s[0] == "window"]
        if opened and closed == CLOSE and win:
            return {"kernels": kernels, "spans": spans,
                    "window": win[0][1:], "lost_markers": OPEN - opened}
    raise RuntimeError(f"{TRIES} profiler sessions lost records (opening "
                       f"markers {opened} of {OPEN}, closing {closed} of "
                       f"{CLOSE})")


def busy_intervals(kernels, lo: float, hi: float) -> List[tuple]:
    """The union of the kernels' intervals inside [lo, hi]."""
    out: List[list] = []
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, each named by the innermost benchmark range the host had
    open when the gap began."""
    lo, hi = trace["window"]
    by_name: Dict[str, float] = {}
    for name, a, b in trace["kernels"]:
        by_name[name[:160]] = by_name.get(name[:160], 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = busy_intervals(trace["kernels"], lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            inner = [s for s in trace["spans"]
                     if s[1] <= a < s[2] and s[0] != "window"]
            label = min(inner, key=lambda s: s[2] - s[1])[0] if inner \
                else "window"
            gaps.append((label, b - a))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def busy_seconds(trace: dict) -> float:
    lo, hi = trace["window"]
    return sum(b - a for a, b in busy_intervals(trace["kernels"], lo, hi))


# -- the card ----------------------------------------------------------------------


def card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
