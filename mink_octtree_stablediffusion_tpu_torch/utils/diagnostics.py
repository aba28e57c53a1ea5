"""Environment diagnostics and backend canaries.

Port of `mink_octtree_stablediffusion_tpu/utils/diagnostics.py` (the
reference's `MinkowskiEngine/diagnostics.py:25-70`): the versions of
Python, PyTorch, CUDA and ``nvcc``, the devices and the card's name; the
device's memory statistics; a self-check that every valid row finds
itself at the centre offset of a kernel map; and a differential suite that
runs one pipeline (geometry, reduction, plain convs in float32 and bf16,
the fused conv, global pooling) on the CPU and on the card and reports
the largest difference of each op.  On the card the fused conv is the
hand-written kernel (B1), held against the card's own bf16 plain conv.
"""

from __future__ import annotations

import platform
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

# each op's tolerance, as in the JAX package (``max_err`` ≤ ``tol``)
TOLERANCES = {"geometry_keys": 0.0, "geometry_valid": 0.0, "reduce": 1e-6,
              "conv": 1e-5, "conv_bf16": 5e-2, "conv_fused_bf16": 5e-2,
              "global_pool": 1e-5}
# the fused conv against the card's own bf16 plain conv
FUSED_VS_PLAIN_TOL = 1e-2


def _nvcc_version() -> Optional[str]:
    from .cuda_build import nvcc_path

    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True, check=True).stdout
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[-1]


def print_diagnostics(file=sys.stdout) -> None:
    print("=" * 46, file=file)
    print("system:", platform.platform(), file=file)
    print("python:", sys.version.split()[0], file=file)
    print("torch:", torch.__version__, "cuda:", torch.version.cuda,
          file=file)
    print("nvcc:", _nvcc_version(), file=file)
    print("numpy:", np.__version__, file=file)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print("cuda devices:", n, file=file)
    for i in range(n):
        print(f"  device {i}:", torch.cuda.get_device_name(i), file=file)
    print("=" * 46, file=file)


def get_device_memory_info(device=None) -> dict:
    """``torch.cuda.memory_stats`` of a CUDA device plus ``free_bytes`` /
    ``total_bytes`` from ``mem_get_info``; ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(dev))
    free, total = torch.cuda.mem_get_info(dev)
    stats.update(free_bytes=int(free), total_bytes=int(total))
    return stats


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def backend_selfcheck(n: int = 2048, res: int = 16, seed: int = 0,
                      device=None) -> bool:
    """True when, on ``device`` (default: the card where there is one),
    every valid row of a random grid finds itself at the centre offset of
    its k3 kernel map, with a conv over that map in the same run."""
    from .. import ops

    dev = torch.device(device) if device is not None else _default_device()
    rng = np.random.RandomState(seed)
    coords = np.concatenate(
        [np.zeros((n, 1), np.int32), rng.randint(0, res, (n, 3))],
        axis=1).astype(np.int32)
    cpad, valid = ops.pad_to_capacity(coords, n)
    kernel = torch.as_tensor(rng.randn(27, 3, 4).astype(np.float32),
                             device=dev)
    spec = ops.KernelSpec(3, 1, ndim=3)
    grid, _, _ = ops.make_grid(torch.as_tensor(cpad, device=dev),
                               torch.as_tensor(valid, device=dev), n,
                               batch_size=1)
    nbr = ops.kernel_map(grid, grid, spec)
    feats = torch.ones((n, 3), device=dev) * grid.valid[:, None]
    ops.sparse_conv_apply(feats, kernel, nbr)
    gv = grid.valid.cpu().numpy()
    center = nbr[spec.volume // 2].cpu().numpy()
    return bool((center[gv] == np.arange(n)[gv]).all())


def differential_inputs(n: int = 1024, res: int = 12, seed: int = 0):
    """The suite's numpy inputs (cpad, valid, feats, kernel), drawn as the
    JAX package draws them."""
    from ..ops.coords import pad_to_capacity

    rng = np.random.RandomState(seed)
    coords = np.concatenate(
        [np.concatenate([np.full((n // 2, 1), b, np.int32),
                         rng.randint(0, res, (n // 2, 3))], axis=1)
         for b in range(2)]).astype(np.int32)
    cpad, valid = pad_to_capacity(coords, n)
    feats = (rng.randn(n, 8) * valid[:, None]).astype(np.float32)
    kernel = (rng.randn(27, 8, 16) * 0.1).astype(np.float32)
    return cpad, valid, feats, kernel


def differential_outputs(device, n: int = 1024, res: int = 12,
                         seed: int = 0, fused: bool = True) -> dict:
    """The suite's pipeline on ``device`` → {op: float32 numpy array}."""
    from .. import ops

    dev = torch.device(device)
    cpad, valid, feats, kernel = (torch.as_tensor(a, device=dev) for a in
                                  differential_inputs(n, res, seed))
    spec = ops.KernelSpec(3, 1, ndim=3)
    grid, inverse, _ = ops.make_grid(cpad, valid, n, batch_size=2,
                                     extent=(res,) * 3)
    f = ops.reduce_by_inverse(feats, inverse, valid, n, "sum")
    nbr = ops.kernel_map(grid, grid, spec)
    out = {"geometry_keys": grid.coords, "geometry_valid": grid.valid,
           "reduce": f,
           "conv": ops.sparse_conv_apply(f, kernel, nbr,
                                         compute_dtype=torch.float32),
           "conv_bf16": ops.sparse_conv_apply(f, kernel, nbr,
                                              compute_dtype=torch.bfloat16)}
    if fused:
        out["conv_fused_bf16"] = ops.fused_sparse_conv(
            f, kernel, grid, grid, spec, compute_dtype=torch.bfloat16)
    bid = torch.where(grid.valid, grid.coords[:, 0], 2)
    out["global_pool"], _ = ops.global_pool(f, bid, 2, grid.valid, "avg")
    return {k: v.detach().to(torch.float32).cpu().numpy()
            for k, v in out.items()}


def backend_differential_suite(n: int = 1024, res: int = 12, seed: int = 0,
                               raise_on_fail: bool = False,
                               device=None) -> dict:
    """The pipeline on the CPU and on ``device`` (default: the card where
    there is one) → ``{op: {"max_err", "tol", "ok"}, ..., "_all_ok"}``.
    The fused conv runs only on the card and is held against the card's
    own bf16 plain conv; on a CPU-only host both runs coincide, the fused
    entry is absent (as in the JAX package) and every entry is 0."""
    dev = torch.device(device) if device is not None else _default_device()
    on_card = dev.type != "cpu"
    ref = differential_outputs("cpu", n, res, seed, fused=False)
    got = differential_outputs(dev, n, res, seed, fused=on_card)
    report = {}
    for k, tol in TOLERANCES.items():
        if k == "conv_fused_bf16":
            if k not in got:
                continue
            err = float(np.max(np.abs(got[k] - got["conv_bf16"])))
            tol = FUSED_VS_PLAIN_TOL
        elif k == "conv_bf16":
            err = float(np.max(np.abs(got[k] - ref["conv"])))
        else:
            err = float(np.max(np.abs(got[k] - ref[k])))
        report[k] = {"max_err": err, "tol": tol, "ok": err <= tol}
    report["_all_ok"] = all(v["ok"] for v in report.values())
    if raise_on_fail and not report["_all_ok"]:
        bad = {k: v for k, v in report.items()
               if k != "_all_ok" and not v["ok"]}
        raise RuntimeError(f"backend differential failures: {bad}")
    return report
