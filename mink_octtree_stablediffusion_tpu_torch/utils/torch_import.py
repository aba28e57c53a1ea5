"""Import reference MinkowskiEngine checkpoints into the port's modules.

Port of `mink_octtree_stablediffusion_tpu/utils/torch_import.py`.  A
trained reference VAE or diffusion UNet (its torch ``state_dict``) is
carried over exactly.  The JAX package's translation rules, copied here,
take each flax parameter path to a reference key and coerce the tensor's
layout; `utils.convert`'s flax → port name map then takes the filled flax
tree onto the port module, so that one map leads from flax paths to port
parameters (`flax_template` inverts it only to list the flax paths of a
module, and `convert.from_flax` checks that the inversion lands on every
parameter of the module once).  Layout transforms:

- conv kernels ``(K, Cin, Cout)`` 1:1; a ``kernel_size=1`` conv stored
  ``(Cin, Cout)`` by the reference (``use_mm``,
  `MinkowskiConvolution.py:263-276`) becomes ``(1, Cin, Cout)``;
- a conv bias ``(1, Cout)`` (`MinkowskiConvolution.py:287`) → ``(Cout,)``;
- ``MinkowskiBatchNorm`` wraps ``nn.BatchNorm1d`` as ``.bn``: weight,
  bias, running_mean, running_var → the BatchNorm's scale, bias, mean,
  var;
- ``MinkowskiStableInstanceNorm`` weight/bias ``(1, C//group)`` →
  ``(C//group,)``;
- ``nn.Linear`` weight ``(out, in)`` → a dense kernel ``(in, out)``;
- attention: the reference's ``sparseAttention``
  (`diffusion_block.py:400-500`) projects q/kv/out twice (its own
  ``to_q``/``to_kv``/``to_out`` and ``nn.MultiheadAttention``'s
  ``in_proj``/``out_proj``); the two stages compose into the single
  projections of `SparseAttention` (``to_q ≡ Wq_toᵀ·Wq_inᵀ``, ``to_kv ≡
  [Wk_toᵀ·Wk_inᵀ | Wv_toᵀ·Wv_inᵀ]``, ``to_out ≡ Wo_projᵀ·Wo_toᵀ``, the
  bias verbatim), which is exact.

Module names (reference → flax): ``encoder.blockN.layer1.0.net.{0,1}`` →
``encoder/blockN/head/{conv,norm}``, ``….layer1.j.(conv|norm)X`` →
``…/blockJ/…``, ``{stack}.{i}.layer1.0 / .j / .last`` →
``{stack}_{i}/head / blockJ / tail``, ``attentions.transformer_encoder.*``
→ ``blockJ/attentions/SparseAttention_0``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn.norm import BatchNorm
from .convert import from_flax

# port module names that stand for an auto-named flax module (the reverse
# of the renames in `utils.convert` that the VAE and the UNet use)
_FLAX_MODULES = {"bn": "BatchNorm_0", "inorm": "StableInstanceNorm_0",
                 "attn": "SparseAttention_0"}
_STAT_LEAVES = {"running_mean": "mean", "running_var": "var"}


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch/Lightning checkpoint as a flat ``{name: np.ndarray}``: the
    ``state_dict`` entry is unwrapped and ``model.``/``module.`` prefixes
    dropped; the reference modules' ``vae.``/``unet.`` prefixes stay for
    `strip_prefix`.  Only tensors and plain containers are unpickled
    (``weights_only``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        for pre in ("model.", "module."):
            if k.startswith(pre):
                k = k[len(pre):]
        if torch.is_tensor(v):
            out[k] = v.detach().cpu().numpy()
    return out


def strip_prefix(sd: Dict[str, np.ndarray], prefix: str
                 ) -> Dict[str, np.ndarray]:
    """The entries under ``prefix`` (e.g. ``"vae."``), the prefix
    removed."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# --- the JAX package's translation rules --------------------------------


def _adapt(val: np.ndarray, tmpl: np.ndarray, key: str) -> np.ndarray:
    """Coerce one torch tensor onto the shape of its flax leaf."""
    val = np.asarray(val, tmpl.dtype)
    if val.shape == tmpl.shape:
        return val
    if val.ndim == 2 and val.shape[0] == 1 and val.shape[1:] == tmpl.shape:
        return val[0]
    if val.ndim == 2 and tmpl.ndim == 3 and tmpl.shape[0] == 1 \
            and val.shape == tmpl.shape[1:]:
        return val[None]
    if val.ndim == 2 and tmpl.ndim == 2 and val.shape == tmpl.shape[::-1]:
        return val.T
    raise ValueError(
        f"{key}: torch shape {val.shape} does not map onto {tmpl.shape}")


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _norm_key(parts, base: str) -> str:
    kind, leaf = parts[-2], parts[-1]
    if kind.startswith("BatchNorm"):
        return f"{base}.bn.{_BN[leaf]}"
    return f"{base}.{leaf}"


def _fold_attention(sd: Dict[str, np.ndarray], base: str, used: set
                    ) -> Dict[str, np.ndarray]:
    """The reference's double projections under ``base``
    (``….attentions.transformer_encoder``) composed into single ones."""
    def take(name):
        used.add(f"{base}.{name}")
        return np.asarray(sd[f"{base}.{name}"], np.float64)

    wq_to = take("to_q.weight")
    wkv_to = take("to_kv.weight")
    wo_to = take("to_out.weight")
    b_out = take("to_out.bias")
    in_proj = take("attn.in_proj_weight")
    wo_proj = take("attn.out_proj.weight")
    d = wq_to.shape[0]
    wq_in, wk_in, wv_in = in_proj[:d], in_proj[d:2 * d], in_proj[2 * d:]
    wk_to, wv_to = wkv_to[:d], wkv_to[d:]
    vals = {"to_q/kernel": wq_to.T @ wq_in.T,
            "to_kv/kernel": np.concatenate([wk_to.T @ wk_in.T,
                                            wv_to.T @ wv_in.T], axis=1),
            "to_out/kernel": wo_proj.T @ wo_to.T, "to_out/bias": b_out}
    return {k: np.asarray(v, np.float32) for k, v in vals.items()}


def _stack_tail_index(paths, stack: str) -> int:
    """The torch Sequential index of a stack's trailing adapt."""
    return 1 + len({p.split("/")[2] for p in paths
                    if p.split("/")[1] == stack and
                    p.split("/")[2].startswith("block")})


_RESNET_STACKS = ("block1", "block2", "block3", "res_mid", "block1_tr",
                  "block2_tr", "block3_tr")


def _translate(parts, all_paths) -> Optional[str]:
    """A flax path (collection first) → the reference key; None for a
    top-level module's nested leaf."""
    stack = parts[1]
    if "attentions" in parts:
        return None
    if stack in ("conv_in", "conv_out", "mean_conv", "log_var_conv") or \
            stack.endswith("_cls"):
        return f"{stack}.{parts[-1]}" if len(parts) == 3 else None
    if stack == "time_embedding":
        leaf = "weight" if parts[3] == "kernel" else "bias"
        return f"{stack}.{parts[2]}.{leaf}"
    if stack[-1].isdigit() and "_" in stack and \
            stack.rsplit("_", 1)[0] in _RESNET_STACKS:
        name, idx = stack.rsplit("_", 1)
        tbase = f"{name}.{idx}.layer1"
    else:
        tbase = f"{stack}.layer1"
    sub = parts[2]
    if sub == "head":
        if parts[3] == "conv":
            return f"{tbase}.0.net.0.{parts[-1]}"
        return _norm_key(parts, f"{tbase}.0.net.1")
    if sub == "tail":
        t = _stack_tail_index(all_paths, stack)
        if parts[3] == "conv":
            return f"{tbase}.{t}.net.0.{parts[-1]}"
        return _norm_key(parts, f"{tbase}.{t}.net.1")
    if sub.startswith("block"):
        j = int(sub[len("block"):])
        mod = parts[3]
        if mod in ("conv1", "conv2"):
            return f"{tbase}.{j}.{mod}.{parts[-1]}"
        if mod in ("norm1", "norm2"):
            return _norm_key(parts, f"{tbase}.{j}.{mod}")
        if mod == "time_emb_proj":
            leaf = "weight" if parts[-1] == "kernel" else "bias"
            return f"{tbase}.{j}.time_emb_proj.{leaf}"
    raise KeyError("no translation for " + "/".join(parts))


# --- the port module's flax paths -----------------------------------------


def flax_template(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """``{flax path: current value in the flax layout}`` for every
    parameter and buffer of ``module``, in the order JAX flattens the tree
    (sorted keys at every level)."""
    out = {}
    for name, t in module.state_dict().items():
        *mods, leaf = name.split(".")
        owner = module.get_submodule(".".join(mods))
        arr = t.detach().cpu().numpy()
        coll = "params"
        if isinstance(owner, BatchNorm):
            if leaf in _STAT_LEAVES:
                coll, leaf = "batch_stats", _STAT_LEAVES[leaf]
            elif leaf == "weight":
                leaf = "scale"
        elif isinstance(owner, torch.nn.Linear) and leaf == "weight":
            leaf, arr = "kernel", arr.T
        path = [coll] + [_FLAX_MODULES.get(m, m) for m in mods] + [leaf]
        out["/".join(path)] = np.ascontiguousarray(arr)
    return dict(sorted(out.items(), key=lambda kv: kv[0].split("/")))


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def convert_module(sd: Dict[str, np.ndarray], module: torch.nn.Module,
                   prefix: str = "", allow_missing: bool = False
                   ) -> Tuple[torch.nn.Module, Dict[str, List[str]]]:
    """Load a reference torch ``state_dict`` into a port VAE (its encoder
    and decoder keyed ``encoder.``/``decoder.`` after ``prefix``) or a
    diffusion UNet.  Returns ``(module, report)``: ``report["missing"]``
    lists the flax paths of the module with no reference source (they keep
    their values; without ``allow_missing`` they raise), and
    ``report["unused"]`` the reference keys under ``prefix`` not read."""
    flat = flax_template(module)
    paths = list(flat)
    scoped_paths = [p.replace("/encoder/", "/").replace("/decoder/", "/")
                    for p in paths]
    new, missing, used = {}, [], set()
    attn_cache: Dict[str, Dict[str, np.ndarray]] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        coll, rest = parts[0], parts[1:]
        tpre = prefix
        if rest[0] in ("encoder", "decoder"):
            tpre = f"{tpre}{rest[0]}."
            rest = rest[1:]
        if "attentions" in rest:
            cut = rest.index("attentions")
            tbase_key = _translate(
                [coll] + rest[:cut] + ["conv1", "kernel"], scoped_paths)
            abase = tpre + tbase_key.rsplit(".conv1.kernel", 1)[0] + \
                ".attentions.transformer_encoder"
            if abase not in attn_cache:
                try:
                    attn_cache[abase] = _fold_attention(sd, abase, used)
                except KeyError:
                    attn_cache[abase] = {}
            key = "/".join(rest[cut + 2:])
            if key in attn_cache[abase]:
                new[path] = _adapt(attn_cache[abase][key], leaf, path)
            else:
                missing.append(path)
                new[path] = leaf
            continue
        try:
            tkey = _translate([coll] + rest, scoped_paths)
        except KeyError:
            tkey = None
        full = None if tkey is None else tpre + tkey
        if full is not None and full in sd:
            used.add(full)
            new[path] = _adapt(sd[full], leaf, path)
        else:
            missing.append(path)
            new[path] = leaf
    if missing and not allow_missing:
        raise KeyError(f"no torch source for {len(missing)} leaves, e.g. "
                       f"{missing[:5]} (pass allow_missing=True to keep "
                       f"their current values)")
    unused = sorted(k for k in sd if k.startswith(prefix) and k not in used
                    and "num_batches_tracked" not in k)
    module.load_state_dict(from_flax(_nest(new), module), strict=True)
    return module, {"missing": missing, "unused": unused}
