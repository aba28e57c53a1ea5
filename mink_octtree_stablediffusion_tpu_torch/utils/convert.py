"""Carry flax variables of the JAX package over to the port's modules.

``from_flax(variables, module)`` walks the flax tree by its real names and
returns a ``state_dict`` for the matching port module:

- conv kernels ``(K, Cin, Cout)`` copy 1:1 (leaf ``kernel``);
- a flax ``Dense`` kernel ``[in, out]`` becomes a ``Linear`` weight
  ``[out, in]``;
- ``BatchNorm_0`` → ``bn``: ``params/{scale,bias}`` → ``weight``/``bias``,
  ``batch_stats/{mean,var}`` → ``running_mean``/``running_var``; a
  BatchNorm named by its parent (the ResNet blocks' ``norm1``…
  ``downsample_norm``, the ResNets' ``bn1``) maps the same leaves under
  its own name;
- ``StableInstanceNorm_0`` → ``inorm``, ``weight``/``bias`` 1:1;
- ``SparseAttention_0`` → ``attn``; a ``MortonWindowTransformer`` keeps
  its projections ``to_q``/``to_kv``/``to_out`` directly under its own
  name (a `BasicBlock`'s ``attentions`` on the window path, the encoder's
  ``window_attn``), and the port holds them under ``attn`` there too, so
  both flax layouts land on one set of projections (a ``DenseAttention``
  is named ``attn`` in flax, and its projections stay there, as they do
  where the module given holds them under the flax path itself);
- the diffusion trainer's ``CoordNLLParams`` (a NamedTuple leaf of the
  params tree ``{"unet": …, "nll": …}``) → ``nll.mu``/``nll.sigma`` 1:1;
- the learned class table of conditioned training (``params["cond_table"]``
  beside ``params["unet"]``) → the ``cond_table`` parameter 1:1;
- ``PReLU``'s ``alpha`` and ``Sinusoidal``'s ``coef`` 1:1; a 2-D
  ``kernel`` that the port keeps in the flax layout (``ChannelwiseConv``'s
  ``[K, C]``, ``Sinusoidal``'s ``[in, out]``: the module given holds a
  ``kernel`` there) 1:1 too; ``AdaptiveLogSoftmaxWithLoss``'s ``head`` and
  ``tail{i}_proj``/``tail{i}_out`` are dense layers of the same names.

The model zoo adds:

- a block's auto-named ``Dense_0`` and ``SparseConv_0`` (the ModelNet40
  classifiers' ``_MLPBlock``/``_ConvBlock``) → ``fc`` and ``conv``;
- parameters named ``{name}_scale``/``{name}_bias`` directly under a
  module (``MinkowskiPointNet``'s masked norms) 1:1;
- the VQ codebook ``params/…/embedding`` 1:1, and the EMA quantizer's
  ``vq_stats`` collection (``embedding``, ``cluster_size``, ``ema_sum``,
  ``steps``, the last kept int32) onto the buffers of the same names;
- a dense 3-D conv kernel ``[kd, kh, kw, Cin, Cout]`` (flax ``nn.Conv``)
  → a ``weight [Cout, Cin, kd, kh, kw]``; ``GroupNorm``/``LayerNorm``
  ``scale``/``bias`` → ``weight``/``bias``, as every norm's.

A UNet with ``remat`` has the same tree as one without (the stacks keep
their names), so it needs nothing more; nor do the ResNet classifiers
(``conv1``, ``bn1``, ``layer{stage}_{i}``, ``conv5`` and the ``final``
dense head) and the squeeze-excite layers' dense ``fc1``/``fc2``, whose
names are the same in both trees; pooling has no parameter.

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
                 "SparseAttention_0": "attn", "Dense_0": "fc",
                 "SparseConv_0": "conv"}
_VQ_STATS = ("embedding", "cluster_size", "ema_sum", "steps")
_STATS = {"mean": "running_mean", "var": "running_var"}
_PROJECTIONS = ("to_q", "to_kv", "to_out")


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if hasattr(v, "_asdict"):  # a NamedTuple of arrays
            v = v._asdict()
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _translate(collection: str, path: Tuple[str, ...], value,
               flax_kernels=frozenset(), port_modules=frozenset()):
    *mods, leaf = path
    if mods and mods[-1] in _PROJECTIONS and (
            len(mods) < 2 or mods[-2] not in ("SparseAttention_0", "attn")
    ) and ".".join(mods) not in port_modules:
        mods = mods[:-1] + ["SparseAttention_0", mods[-1]]
    name = [_MODULE_NAMES.get(m, m) for m in mods]
    if collection == "vq_stats" and leaf in _VQ_STATS:
        return ".".join(name + [leaf]), np.array(
            value, np.int32 if leaf == "steps" else np.float32)
    arr = np.array(value, np.float32)
    if collection == "batch_stats" and leaf in _STATS:
        return ".".join(name + [_STATS[leaf]]), arr
    if collection == "params":
        if leaf == "kernel" and (arr.ndim == 3 or ".".join(
                name + ["kernel"]) in flax_kernels):
            return ".".join(name + ["kernel"]), arr
        if leaf == "kernel" and arr.ndim == 2:
            return ".".join(name + ["weight"]), arr.T
        if leaf == "kernel" and arr.ndim == 5:
            return ".".join(name + ["weight"]), arr.transpose(4, 3, 0, 1, 2)
        if leaf in ("bias", "weight", "mu", "sigma", "cond_table", "alpha",
                    "coef", "embedding") or leaf.endswith(("_scale",
                                                           "_bias")):
            return ".".join(name + [leaf]), arr
        if leaf == "scale":
            return ".".join(name + ["weight"]), arr
    raise KeyError(f"no port counterpart for {collection}/{'/'.join(path)}")


def from_flax(variables, module: Optional[torch.nn.Module] = None
              ) -> Dict[str, torch.Tensor]:
    """flax variables (``{"params": …, "batch_stats": …}``) → state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    ref = module.state_dict() if module is not None else {}
    port_modules = frozenset(n.rsplit(".", 1)[0] for n in ref)
    flax_kernels = frozenset(n for n, t in ref.items()
                             if n.rsplit(".", 1)[-1] == "kernel" and
                             t.dim() == 2)
    for collection, tree in variables.items():
        for path, value in _leaves(tree):
            name, arr = _translate(collection, path, value, flax_kernels,
                                   port_modules)
            if name in sd:
                raise KeyError(f"two flax leaves map onto {name}")
            sd[name] = torch.from_numpy(np.array(arr, order="C"))  # 0-d stays 0-d
    if module is not None:
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
