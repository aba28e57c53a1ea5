"""Per-level octree occupancy of a workload and the capacity schedule it
implies: the counterpart of `scripts/measure_occupancy.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.measure_occupancy
    python -m mink_octtree_stablediffusion_tpu_torch.train.measure_occupancy \\
        --resolution 32 --points 2000 --samples 2 --procedural

Host numpy, no kernel: voxelize ``--samples`` clouds of the workload
(sphere shells, `train.vae_step_common.shell_cloud` from ``RandomState(0)``,
or with ``--procedural`` the port's `ProceduralShapes`), count the unique
cells at each encoder stride (1, 2, 4, 8), and size every buffer from the
measured counts N_s (the mean over the samples, times ``--batch``):

  encoder level s:  1.25 x N_s for s = 2, 4, 8, 8, 8;
  decoder level l:  1.25 x N_8, then 8 x 1.1 x N_8, N_4, N_2 (the
                    generative k2s2 growth of the previous level's kept
                    set, the target in training);
  input capacity:   1.25 x N_1;

each rounded up to 1024.  Same flags, defaults (resolution 128, batch 4,
250,000 points, 16 samples) and printed lines as the script; the
``--device`` flag is accepted for symmetry with the other entry points
and unused.  ``main`` returns the schedule.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..data import ProceduralShapes
from .vae_step_common import shell_cloud


def up1024(n) -> int:
    return int(-(-int(n) // 1024) * 1024)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--points", type=int, default=250000)
    ap.add_argument("--procedural", action="store_true",
                    help="use ProceduralShapes instead of the shell fixture")
    ap.add_argument("--samples", type=int, default=16,
                    help="clouds to average over")
    ap.add_argument("--device", type=str, default=None,
                    help="accepted and unused: the measurement is host "
                         "numpy")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    rng = np.random.RandomState(0)
    counts = {1: [], 2: [], 4: [], 8: []}
    for i in range(args.samples):
        if args.procedural:
            ds = ProceduralShapes(resolution=args.resolution,
                                  num_samples=args.samples,
                                  points_per_shape=args.points)
            vox = ds[i]["coords"]
        else:
            vox = shell_cloud(rng, args.points, args.resolution)
        for s in counts:
            counts[s].append(len(np.unique(vox // s, axis=0)))

    b = args.batch
    n = {s: float(np.mean(v)) for s, v in counts.items()}
    print("mean voxels/shape by stride: " +
          ", ".join(f"s{s}={n[s]:.0f}" for s in sorted(n)), flush=True)
    n1, n2, n4, n8 = (b * n[s] for s in (1, 2, 4, 8))
    enc = tuple(up1024(1.25 * x) for x in (n2, n4, n8, n8, n8))
    dec = (up1024(1.25 * n8), up1024(8 * 1.1 * n8), up1024(8 * 1.1 * n4),
           up1024(8 * 1.1 * n2))
    input_cap = up1024(1.25 * n1)
    print(f"measured schedule (batch {b}):")
    print(f"  input_capacity {input_cap}")
    print(f"  encoder_capacities {enc}")
    print(f"  decoder_capacities {dec}")
    print("  --caps " + " ".join(map(str, enc + dec)))
    return {"mean_voxels_by_stride": n, "input_capacity": input_cap,
            "encoder_capacities": enc, "decoder_capacities": dec}


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
