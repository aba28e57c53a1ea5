"""Carry flax variables of the JAX package over to the port's modules.

``from_flax(variables, module)`` walks the flax tree by its real names and
returns a ``state_dict`` for the matching port module:

- conv kernels ``(K, Cin, Cout)`` copy 1:1 (leaf ``kernel``);
- a flax ``Dense`` kernel ``[in, out]`` becomes a ``Linear`` weight
  ``[out, in]``;
- ``BatchNorm_0`` → ``bn``: ``params/{scale,bias}`` → ``weight``/``bias``,
  ``batch_stats/{mean,var}`` → ``running_mean``/``running_var``;
- ``StableInstanceNorm_0`` → ``inorm``, ``weight``/``bias`` 1:1;
- ``SparseAttention_0`` → ``attn``;
- the diffusion trainer's ``CoordNLLParams`` (a NamedTuple leaf of the
  params tree ``{"unet": …, "nll": …}``) → ``nll.mu``/``nll.sigma`` 1:1.

Every other module name is the same in both trees.  Given the module, the
cover is checked one to one: every flax leaf lands on a port parameter or
buffer of the same shape, and every port parameter or buffer is set.
(`mink_octtree_stablediffusion_tpu/utils/torch_import.py` documents the
reverse mapping, from the reference's torch checkpoints to flax.)
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_MODULE_NAMES = {"BatchNorm_0": "bn", "StableInstanceNorm_0": "inorm",
                 "SparseAttention_0": "attn"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if hasattr(v, "_asdict"):  # a NamedTuple of arrays
            v = v._asdict()
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _translate(collection: str, path: Tuple[str, ...], value):
    *mods, leaf = path
    name = [_MODULE_NAMES.get(m, m) for m in mods]
    arr = np.array(value, np.float32)
    if collection == "batch_stats" and leaf in _STATS:
        return ".".join(name + [_STATS[leaf]]), arr
    if collection == "params":
        if leaf == "kernel" and arr.ndim == 3:
            return ".".join(name + ["kernel"]), arr
        if leaf == "kernel" and arr.ndim == 2:
            return ".".join(name + ["weight"]), arr.T
        if leaf in ("bias", "weight", "mu", "sigma"):
            return ".".join(name + [leaf]), arr
        if leaf == "scale":
            return ".".join(name + ["weight"]), arr
    raise KeyError(f"no port counterpart for {collection}/{'/'.join(path)}")


def from_flax(variables, module: Optional[torch.nn.Module] = None
              ) -> Dict[str, torch.Tensor]:
    """flax variables (``{"params": …, "batch_stats": …}``) → state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, value in _leaves(tree):
            name, arr = _translate(collection, path, value)
            if name in sd:
                raise KeyError(f"two flax leaves map onto {name}")
            sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    if module is not None:
        ref = module.state_dict()
        missing = sorted(set(ref) - set(sd))
        unused = sorted(set(sd) - set(ref))
        if missing or unused:
            raise KeyError(f"flax/port cover is not one to one: port "
                           f"entries never set {missing[:8]}, flax leaves "
                           f"unused {unused[:8]}")
        for name, t in ref.items():
            if tuple(t.shape) != tuple(sd[name].shape):
                raise ValueError(f"{name}: flax shape {tuple(sd[name].shape)}"
                                 f" vs port shape {tuple(t.shape)}")
    return sd


def load_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy flax variables into ``module`` (strict one-to-one cover)."""
    module.load_state_dict(from_flax(variables, module), strict=True)
    return module
