"""The port's dense 3D UNets and the dense diffusion entry point against the
JAX package, on the CPU, float32.

Weights: random flax variables carried into the port by ``utils.convert``
(5-D conv kernels ``[k, k, k, Cin, Cout]`` transposed to ``[Cout, Cin, k,
k, k]``); the same numpy inputs, channel-last.  Every dense block
(``ResnetBlock3D`` with the default and the scale-shift time embedding and
without one, ``Attention3D`` with two heads, ``Downsample3D`` on an even
and an odd size — flax's ``SAME`` pads (0, 1) and (1, 1) there —
``Upsample3D``, ``DenseAttention`` self and cross, ``DenseTransformer3D``):
output and input gradient within 1e-4·max|ref|.  ``UNet3DModel`` and
``UNet3DConditionModel`` (with and without a condition): output within
1e-4·max|ref|, and one train step of `examples/diffusion_dense.py`'s loss
on given timesteps and noise: the loss within 1e-5 relative, every
gradient within 1e-4·max|ref| of that tensor's ``jax.value_and_grad``.
Then ``train.diffusion_dense`` for 2 steps with ``--device cpu``, with and
without ``--with_cond``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mink_octtree_stablediffusion_tpu import diffusion as jdiff
from mink_octtree_stablediffusion_tpu import models as mm
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.train import diffusion_dense as td
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

torch.set_num_threads(1)
REL = 1e-4
B = 2


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=REL * max(np.abs(ref).max(), 1e-30),
                               err_msg=err_msg)


def _carry(jmod, pmod, rng, *args):
    """Kernels at LeCun scale over their fan-in, other leaves N(0, 0.3²)."""
    abstract = jax.eval_shape(
        lambda *a: jmod.init(jax.random.PRNGKey(0), *a), *args)

    def draw(path, x):
        std = 0.3
        if str(path[-1].key) == "kernel":
            std = 1.0 / np.sqrt(np.prod(x.shape[:-1]))
        return jnp.asarray(rng.randn(*x.shape).astype(np.float32) * std)
    variables = jax.tree_util.tree_map_with_path(draw, abstract)
    load_flax(pmod, variables)
    return variables


def _block(name):
    """(JAX module, port module, input shape, extra inputs)."""
    rs = np.random.RandomState(7)
    temb = rs.randn(B, 12).astype(np.float32)
    ehs = rs.randn(B, 3, 6).astype(np.float32)
    if name.startswith("resnet"):
        norm = "scale_shift" if name == "resnet_scale_shift" else "default"
        tc = None if name == "resnet_no_temb" else 12
        return (mm.ResnetBlock3D(8, groups=4, time_embedding_norm=norm),
                mp.models.ResnetBlock3D(4, 8, 4, norm, tc, device="cpu"),
                (B, 6, 6, 6, 4), () if tc is None else (temb,))
    if name == "attention3d":
        return (mm.Attention3D(num_heads=2, groups=4),
                mp.models.Attention3D(8, 2, 4, device="cpu"),
                (B, 4, 4, 4, 8), ())
    if name.startswith("downsample"):
        n = 8 if name == "downsample_even" else 7
        return (mm.Downsample3D(6), mp.models.Downsample3D(4, 6,
                                                           device="cpu"),
                (B, n, n, n, 4), ())
    if name == "upsample":
        return (mm.Upsample3D(6), mp.models.Upsample3D(4, 6, device="cpu"),
                (B, 3, 3, 3, 4), ())
    if name == "dense_attention_self":
        return (mm.DenseAttention(num_heads=2),
                mp.models.DenseAttention(8, 2, device="cpu"), (B, 20, 8), ())
    if name == "dense_attention_cross":
        return (mm.DenseAttention(num_heads=2, cross_attention_dim=6),
                mp.models.DenseAttention(8, 2, 6, device="cpu"), (B, 20, 8),
                (ehs,))
    return (mm.DenseTransformer3D(num_heads=2, cross_attention_dim=6),
            mp.models.DenseTransformer3D(8, 2, 6, device="cpu"),
            (B, 3, 3, 3, 8), (ehs,))


BLOCKS = ["resnet_default", "resnet_scale_shift", "resnet_no_temb",
          "attention3d", "downsample_even", "downsample_odd", "upsample",
          "dense_attention_self", "dense_attention_cross",
          "dense_transformer"]


@pytest.mark.parametrize("name", BLOCKS)
def test_dense_blocks_match_jax(rng, name):
    jmod, pmod, shape, extra = _block(name)
    x = rng.randn(*shape).astype(np.float32)
    variables = _carry(jmod, pmod, rng, jnp.asarray(x),
                       *map(jnp.asarray, extra))
    ref = jax.jit(lambda v, x: jmod.apply(v, x, *extra))(variables, x)
    gout = rng.randn(*ref.shape).astype(np.float32)
    rgrad = jax.jit(jax.grad(lambda x: jnp.vdot(
        jmod.apply(variables, x, *extra), gout)))(x)
    px = _t(x).requires_grad_()
    out = pmod(px, *map(_t, extra))
    (out * _t(gout)).sum().backward()
    assert out.shape == ref.shape
    _close(out, ref)
    _close(px.grad, rgrad)


R = 8
UNCOND = dict(block_channels=(8, 16), attn_levels=(1,), groups=4)
COND = dict(block_channels=(8, 16), cross_attention_dim=6,
            attention_head_dim=4, groups=4, cross_attn_levels=(1,))


def _unet(kind):
    if kind == "uncond":
        return (mm.UNet3DModel(out_channels=1, **UNCOND),
                mp.models.UNet3DModel(1, 1, **UNCOND, device="cpu"))
    return (mm.UNet3DConditionModel(out_channels=1, **COND),
            mp.models.UNet3DConditionModel(1, 1, **COND, device="cpu"))


def _inputs(rng):
    x0 = (rng.rand(B, R, R, R, 1) > 0.7).astype(np.float32)
    t = np.array([3, 700], np.int32)
    noise = rng.randn(*x0.shape).astype(np.float32)
    ehs = rng.randn(B, 1, 6).astype(np.float32)
    return x0, t, noise, ehs


@pytest.mark.parametrize("kind", ["uncond", "cond", "cond_without_ehs"])
def test_unet3d_forward_matches_jax(rng, kind):
    jnet, pnet = _unet("uncond" if kind == "uncond" else "cond")
    x, t, _, ehs = _inputs(rng)
    x = rng.randn(*x.shape).astype(np.float32)
    args = (x, t) + ((ehs,) if kind != "uncond" else ())
    variables = _carry(jnet, pnet, rng, *args)
    if kind == "cond_without_ehs":
        args = (x, t, None)
    ref = jax.jit(lambda v, *a: jnet.apply(v, *a))(variables, *args)
    with torch.no_grad():
        got = pnet(*(None if a is None else _t(a) for a in args))
    _close(got, ref)


@pytest.mark.parametrize("kind", ["uncond", "cond"])
def test_unet3d_step_matches_jax(rng, kind):
    jnet, pnet = _unet(kind)
    x0, t, noise, ehs = _inputs(rng)
    cond = kind == "cond"
    variables = _carry(jnet, pnet, rng, x0, t, *((ehs,) if cond else ()))
    sched = jdiff.DDPMScheduler.create()

    def loss_fn(params):  # examples/diffusion_dense.py, t and noise given
        xt = sched.add_noise(jnp.asarray(x0), jnp.asarray(noise),
                             jnp.asarray(t))
        eps = jnet.apply({"params": params}, xt, jnp.asarray(t),
                         *((jnp.asarray(ehs),) if cond else ()))
        return jnp.mean((eps - noise) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    ploss, _ = td.build_loss_fn(mp.diffusion.DDPMScheduler.create(),
                                with_cond=cond, device="cpu")(
        pnet, (x0, ehs if cond else None), timesteps=_t(t).long(),
        noise=_t(noise))
    ploss.backward()
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-5)
    named = dict(pnet.named_parameters())
    ref_grads = from_flax({"params": grads})
    assert set(ref_grads) == set(named)
    for name, ref in ref_grads.items():
        _close(named[name].grad, ref.numpy(), err_msg=name)


@pytest.mark.parametrize("with_cond", [False, True])
def test_train_diffusion_dense_entry_point(capsys, with_cond):
    argv = ["--device", "cpu", "--resolution", "8", "--block_channels", "8",
            "16", "--steps", "2"] + (["--with_cond"] if with_cond else [])
    out = td.main(argv)
    assert out["step"] == 2 and np.isfinite(out["final_loss"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        out


def test_class_table_matches_example():
    np.testing.assert_array_equal(
        td.class_table(4, 64),
        np.random.RandomState(0).randn(4, 1, 64).astype(np.float32))
