"""Readings from which a cell's correctness limits are set (not run by the
benchmark's own runs).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        [--control int8 ...] [--faults half_batch] [--detail]

For each seed, on the card at the cell's own size: the program's set-up
and first steps as a run makes them, and the cell's compared numbers for

- ``program``: the program against the float32 reference (the lower
  reading);
- ``control``: the reference computed at a precision below the one the
  configuration states (``--control``, default int8 for bf16 products)
  in the program's place;
- each fault of ``--faults`` planted in the program (``half_batch``: the
  second half of each batch's instances left out of the program's input,
  its mean taken over the rest).

Prints one JSON line a reading; with ``--out`` also appends them to that
file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def half_batch(cell) -> None:
    """Leave the second half of every batch's instances out of the
    program's feed."""
    for args, _ in cell.feed:
        coords, valid = args[0][0], args[0][1]
        n = int(coords[valid][:, 0].max()) + 1
        valid &= coords[:, 0] < (n + 1) // 2


FAULTS = {"half_batch": half_batch}


def program(spec: dict, seed: int, device, fault=None):
    """A cell set up as a run sets it up (with ``fault`` planted in its
    feed), its program's state released."""
    cell = harness.entry_module(spec["mix"]["entry"]).Cell(spec, seed,
                                                            device)
    if fault is not None:
        build = cell.build

        def broken():
            out = build()
            cell.feed = out[4]
            FAULTS[fault](cell)
            return out
        cell.build = broken
    cell.setup()
    if getattr(cell, "checks_the_window", False):
        cell.window(1e-3, False)  # one request
    cell.release()
    return cell


def details(got: dict, ref: dict) -> dict:
    """Every number the cell's check can compare (training cells)."""
    if "grad1" not in got:
        return {}
    from benchmark.entries.training import readings as training_readings
    return training_readings(got, ref)


def readings(spec: dict, seed: int, device, control, faults,
             detail: bool = False) -> list:
    """The program's, the control's and each fault's compared numbers on
    one seed."""
    def row(what, checks, t):
        return {"workload": spec["cell"]["name"], "seed": seed,
                "what": what, "seconds": time.perf_counter() - t,
                **{c["name"]: c["value"] for c in checks}}
    t = time.perf_counter()
    cell = program(spec, seed, device)
    ref = cell.reference()
    got = cell.prog_readings()
    out = [row("program", cell.compare(got, ref), t)]
    if detail:
        out[-1]["detail"] = details(got, ref)
    for c in control:
        t = time.perf_counter()
        low = cell.reference(c)
        out.append(row("control:" + c, cell.compare(low, ref), t))
        if detail:
            out[-1]["detail"] = details(low, ref)
    for fault in faults:
        t = time.perf_counter()
        broken = program(spec, seed, device, fault)
        out.append(row("fault:" + fault,
                       broken.compare(broken.prog_readings(), ref), t))
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", nargs="*", default=["int8"])
    p.add_argument("--detail", action="store_true")
    p.add_argument("--control_seeds", type=int, default=None,
                   help="run the controls and faults on the first N seeds "
                   "only (default: every seed)")
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    spec = harness.cell_spec(harness.benchmark_file(), args.workload)
    device = torch.device("cuda")
    for n, seed in enumerate(args.seeds):
        extra = args.control_seeds is None or n < args.control_seeds
        for r in readings(spec, seed, device, args.control if extra else [],
                          args.faults if extra else [], args.detail):
            print(json.dumps(r), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(r) + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
