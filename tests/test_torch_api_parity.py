"""Every public name of the JAX package resolves in the port.

For each subpackage, each name of the JAX package's ``__all__`` (for
``native``, which has none, each function it defines) is an attribute of
the port's counterpart, or stands in ``NOT_PORTED`` below with its
reason.  A name of that table must still be missing from the port (the
table shrinks as names are ported), and where the reason names a port
counterpart, that counterpart must exist.
"""

import importlib
import inspect

import pytest

JAX_PKG = "mink_octtree_stablediffusion_tpu"
PORT_PKG = "mink_octtree_stablediffusion_tpu_torch"

# (subpackage, name) → (reason, port counterpart or None)
NOT_PORTED = {
    ("nn", "remat_stack"): ("flax's nn.remat of a stack; the port "
                            "rematerializes through nn.blocks.remat_call",
                            "nn.blocks.remat_call"),
    ("train", "mixed_precision_params"): (
        "a function of the flax train state; the port's bf16 storage is "
        "the class train.MixedPrecisionParams",
        "train.MixedPrecisionParams"),
    ("ops", "coo_spmm"): ("no module of the JAX package calls it", None),
}
for _name in ("batch_sharding", "replicate", "shard_batch_pytree",
              "param_shardings", "dp_tp_mesh", "shard_model_params"):
    NOT_PORTED[("parallel", _name)] = (
        "JAX sharding: the port's data parallelism is torch.distributed, "
        "and it does not train under tensor parallelism", None)

SUBPACKAGES = ["", "data", "diffusion", "models", "native", "nn", "ops",
               "parallel", "train", "utils"]


def _public(module):
    names = getattr(module, "__all__", None)
    if names is not None:
        return list(names)
    return [n for n, v in vars(module).items()
            if not n.startswith("_") and inspect.isfunction(v)
            and v.__module__ == module.__name__]


def _resolve(path):
    obj = importlib.import_module(PORT_PKG)
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_public_names_resolve_in_the_port(sub):
    suffix = f".{sub}" if sub else ""
    jmod = importlib.import_module(JAX_PKG + suffix)
    pmod = importlib.import_module(PORT_PKG + suffix)
    names = _public(jmod)
    assert names
    missing = [n for n in names if not hasattr(pmod, n)
               and (sub, n) not in NOT_PORTED]
    assert not missing, f"{JAX_PKG + suffix}: not in the port: {missing}"
    for (s, n), (reason, counterpart) in NOT_PORTED.items():
        if s != sub:
            continue
        assert n in names and reason
        assert not hasattr(pmod, n), f"{n} is ported: drop it from the table"
        if counterpart is not None:
            assert _resolve(counterpart) is not None
