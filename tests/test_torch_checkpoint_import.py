"""Importing reference MinkowskiEngine checkpoints into the port.

A seeded reference ``state_dict`` laid out by the JAX package's own rules
(as its ``tests/test_torch_import.py`` builds one: every flax leaf
translated to its reference key and shape, the attention's double
projections drawn separately) goes through the JAX package's
``convert_module`` and through the port's; the port's parameters equal
``from_flax`` of JAX's result exactly, the folded attention of a UNet
with attention included, and the two reports agree (also with keys
missing and unused).  The flax trees come from ``jax.eval_shape`` (no
``init`` compiles); beside them ``count_params`` equals JAX's count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu import models as mm
from mink_octtree_stablediffusion_tpu.utils import torch_import as jti
from mink_octtree_stablediffusion_tpu_torch.utils import torch_import as pti
from mink_octtree_stablediffusion_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)
CAP, B = 512, 2
VCH, ENC, DEC = (8, 16, 16, 16, 4), (256, 64, 32, 32, 32), \
    (32, 256, 1024, 4096)
UNET = dict(channels=(4, 8, 16, 16), attn_max_len=32,
            down_capacities=(32, 16, 8), group=4, with_attn=True)


def _st(channels, stride, extent):
    return jax.eval_shape(lambda c, v: mt.sparse_tensor(
        c, jnp.ones((CAP, channels)), capacity=CAP, batch_size=B, valid=v,
        stride=stride, extent=extent), jnp.zeros((CAP, 4), jnp.int32),
        jnp.zeros((CAP,), bool))


def _concrete(abstract):
    return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), abstract)


@pytest.fixture(scope="module")
def models():
    key = jax.random.PRNGKey(0)
    s1 = _st(1, 1, (16,) * 3)
    jvae = mm.VAE(channels=VCH, encoder_capacities=ENC,
                  decoder_capacities=DEC)
    vae_vars = jax.eval_shape(lambda s: jvae.init(key, s, s.grid, key), s1)
    lat = _st(4, 8, (32,) * 3)
    unet_vars = jax.eval_shape(lambda s: mm.UNet(**UNET).init(
        key, s, jnp.zeros((B,), jnp.int32)), lat)
    return {"vae": (_concrete(vae_vars), lambda: mp.models.VAE(
                channels=VCH, encoder_capacities=ENC, decoder_capacities=DEC,
                device="cpu")),
            "unet": (_concrete(unet_vars),
                     lambda: mp.models.UNet(device="cpu", **UNET))}


def _torch_shape(tkey, tmpl):
    """The reference's layout of a key (JAX's test rules)."""
    if tkey.endswith(".kernel"):
        return tmpl.shape[1:] if (tmpl.ndim == 3 and tmpl.shape[0] == 1) \
            else tmpl.shape
    if ".bn." in tkey:
        return tmpl.shape
    if tkey.endswith(".bias") and any(
            s in tkey for s in ("time_emb_proj", "linear_1", "linear_2")):
        return tmpl.shape
    if tkey.endswith(".weight"):
        return tmpl.shape[::-1] if tmpl.ndim == 2 else (1,) + tmpl.shape
    if tkey.endswith(".bias"):
        return (1,) + tmpl.shape
    raise AssertionError(tkey)


def _synth_sd(variables, rng):
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    paths = ["/".join(str(k.key) for k in p) for p, _ in flat]
    scoped = [p.replace("/encoder/", "/").replace("/decoder/", "/")
              for p in paths]
    sd, attn = {}, {}
    for path, (_, leaf) in zip(paths, flat):
        parts = path.split("/")
        coll, rest = parts[0], parts[1:]
        tpre = ""
        if rest[0] in ("encoder", "decoder"):
            tpre, rest = f"{rest[0]}.", rest[1:]
        if "attentions" in rest:
            cut = rest.index("attentions")
            tkey = jti._translate([coll] + rest[:cut] + ["conv1", "kernel"],
                                  scoped)
            base = (tpre + tkey.rsplit(".conv1.kernel", 1)[0] +
                    ".attentions.transformer_encoder")
            if rest[cut + 2] == "to_q":
                attn[base] = leaf.shape[-1]
            continue
        tkey = tpre + jti._translate([coll] + rest, scoped)
        val = (rng.randn(*_torch_shape(tkey, leaf)) * 0.05).astype(
            np.float32)
        if tkey.endswith("running_var"):
            val = np.abs(val) + 0.1
        sd[tkey] = val
    for base, d in sorted(attn.items()):
        for name, shape in (("to_q.weight", (d, d)),
                            ("to_kv.weight", (2 * d, d)),
                            ("to_out.weight", (d, d)), ("to_out.bias", (d,)),
                            ("attn.in_proj_weight", (3 * d, d)),
                            ("attn.out_proj.weight", (d, d))):
            sd[f"{base}.{name}"] = rng.randn(*shape).astype(np.float32)
    return sd


@pytest.mark.parametrize("name", ["vae", "unet"])
def test_convert_module_matches_jax(models, name, rng):
    variables, make = models[name]
    pmod = make()
    assert mp.utils.count_params(pmod) == sum(
        x.size for x in jax.tree.leaves(variables["params"]))
    sd = _synth_sd(variables, rng)
    if name == "unet":
        assert any(".attentions.transformer_encoder." in k for k in sd)
    jvars, jrep = jti.convert_module(sd, variables)
    _, prep = pti.convert_module(sd, pmod)
    assert prep == jrep == {"missing": [], "unused": []}
    want = from_flax(jax.tree.map(np.asarray, jvars), pmod)
    got = pmod.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)
    # a partial checkpoint with a stray key: the same report
    drop = sorted(sd)[::7]
    part = {k: v for k, v in sd.items() if k not in drop}
    part["stray.weight"] = np.zeros(3, np.float32)
    part["x.num_batches_tracked"] = np.zeros((), np.int64)
    _, jrep = jti.convert_module(part, variables, allow_missing=True)
    _, prep = pti.convert_module(part, make(), allow_missing=True)
    assert prep == jrep and prep["missing"]
    assert "stray.weight" in prep["unused"]
    assert not any("num_batches_tracked" in k for k in prep["unused"])
    with pytest.raises(KeyError):
        pti.convert_module(part, make())


def test_prefixed_checkpoint_round_trip(models, rng, tmp_path):
    variables, make = models["vae"]
    sd = _synth_sd(variables, rng)
    ckpt = {"state_dict": {f"model.vae.{k}": torch.as_tensor(v)
                           for k, v in sd.items()},
            "epoch": 3}
    path = tmp_path / "ref.ckpt"
    torch.save(ckpt, path)
    flat = pti.load_torch_state_dict(str(path))
    assert set(flat) == {f"vae.{k}" for k in sd}
    sub = pti.strip_prefix(flat, "vae.")
    for k in sd:
        np.testing.assert_array_equal(sub[k], sd[k])
    a, rep_a = pti.convert_module(flat, make(), prefix="vae.")
    b, rep_b = pti.convert_module(sd, make())
    assert rep_a == rep_b == {"missing": [], "unused": []}
    for k, t in a.state_dict().items():
        torch.testing.assert_close(t, b.state_dict()[k], rtol=0, atol=0)
