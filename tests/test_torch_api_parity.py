"""Every public name of the JAX package resolves in the port.

For each subpackage, each name of the JAX package's ``__all__`` (for
``native``, which has none, each function it defines) is an attribute of
the port's counterpart, or stands in ``NOT_PORTED`` below with its
reason.  A name of that table must still be missing from the port (the
table shrinks as names are ported), and where the reason names a port
counterpart, that counterpart must exist.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest
import torch

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


# -- the port stands alone, and its entry points run on the card ------------

ROOT = Path(__file__).resolve().parent.parent
# entry points whose --device flag is accepted and unused: host numpy only
HOST_ONLY = {"train/measure_occupancy.py"}


def _port_sources():
    files = sorted((ROOT / PORT_PKG).rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported(tree):
    """Every absolute module name an ``import``, a ``from ... import``, an
    ``importlib.import_module("...")`` or an ``__import__("...")`` of the
    tree names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args and
              isinstance(node.args[0], ast.Constant) and
              isinstance(node.args[0].value, str) and
              (getattr(node.func, "attr", None) == "import_module" or
               getattr(node.func, "id", None) == "__import__")):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_sources():
        for name in _imported(ast.parse(path.read_text())):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "flax", "optax", JAX_PKG):
                bad.append((str(path.relative_to(ROOT)), name))
    assert not bad, bad
    assert len(_port_sources()) > 50


def _device_flag(tree):
    """The ``default`` of the ``--device`` argument of a module's parser
    (absent: ``None``), or ``"no flag"``."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and
                getattr(node.func, "attr", None) == "add_argument" and
                node.args and isinstance(node.args[0], ast.Constant) and
                node.args[0].value == "--device"):
            for kw in node.keywords:
                if kw.arg == "default":
                    return ast.literal_eval(kw.value)
            return None
    return "no flag"


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    """Every entry point with a ``--device`` flag defaults to the card
    (``None``, which ``utils.device.resolve_device`` turns into ``cuda``,
    or ``"cuda"``) and resolves it through ``resolve_device``, which raises
    where PyTorch sees no card instead of falling back to the CPU."""
    from mink_octtree_stablediffusion_tpu_torch.utils import device
    entries = []
    for path in _port_sources():
        src = path.read_text()
        default = _device_flag(ast.parse(src))
        if default == "no flag":
            continue
        rel = str(path.relative_to(ROOT / PORT_PKG))
        entries.append(rel)
        assert default in (None, "cuda"), (rel, default)
        if rel not in HOST_ONLY:
            assert "resolve_device(" in src or "rank_device(" in src, rel
    assert {"train/e2e_quality.py", "train/vqvae_quality.py",
            "train/diag_eval_decode.py", "train/measure_occupancy.py",
            "train/vae.py", "generate.py"} <= set(entries)
    assert device.resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            device.resolve_device(None)
