"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/``) and a traffic mix (``benchmark/traffic/``); the
mix names the entry that drives the program (``benchmark/entries/``),
and the per-layer metrics are read by ``benchmark/metrics/<name>.py``.
The run sets up (weights and inputs from the seed, the warm-up), measures
for ``--seconds``, with ``--trace 1`` also profiles a bounded slice, then
checks what the timed path produced against the plain reference under
``benchmark/reference/`` and prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics), ``device``, ``breakdown`` (traced) and ``checks``, each
compared number beside its limit.  It runs only on a CUDA card and exits
with 2 where there is none, and with 3 where the process loaded JAX or
the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from benchmark import harness  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def selected(metrics, workload: str) -> list:
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def run_cell(bench: dict, spec: dict, seed: int, seconds: float,
             trace: bool, device, t0: float) -> dict:
    """Set up, measure, profile and check one cell on ``device`` → the
    result object (without the import guard's verdict)."""
    import torch

    name = spec["cell"]["name"]
    cell = harness.entry_module(spec["mix"]["entry"]).Cell(spec, seed,
                                                            device)
    cell.setup()
    harness.sync(device)
    setup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ctx = cell.window(seconds, trace)
    ctx["setup_s"] = setup_s
    dev_info = harness.card(device)
    ctx["peak_mem_gib"] = dev_info["memory_peak_bytes"] / 2 ** 30
    if trace and device.type == "cuda":
        ctx["trace"] = cell.profile()
        lo, hi = ctx["trace"]["window"]
        dev_info["busy_s"] = harness.busy_seconds(ctx["trace"])
        dev_info["window_s"] = hi - lo
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check()
    if trace:
        ctx.update(cell.trace_context())
        metrics = {}
        for m in selected(bench["per_layer"], name):
            value = harness.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": ctx[m["name"]], "unit": m["unit"]}
                   for m in selected(bench["end_to_end"], name)}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks),
           "attempted": ctx["attempted"], "failed": ctx["failed"],
           "metrics": metrics, "device": dev_info}
    if trace and "trace" in ctx:
        out["breakdown"] = harness.breakdown(ctx["trace"])
    if ctx.get("notes"):
        out["notes"] = ctx["notes"]
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = harness.benchmark_file()
    spec = harness.cell_spec(bench, args.workload)
    import torch

    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: needs {need} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    out = run_cell(bench, spec, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), T0)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"benchmark: the process loaded {bad}; no result",
              file=sys.stderr)
        return 3
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    for k, v in out.get("notes", {}).items():
        print(f"{k}: {v}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
