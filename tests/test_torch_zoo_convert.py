"""``utils.convert`` on the model zoo's flax trees, on the CPU: every
model's variables (shapes from ``jax.eval_shape`` of ``init``, no
compile) land one to one on the port's parameters and buffers
(``load_flax``'s cover and shape checks), including the auto-named
``Dense_0``/``SparseConv_0``/``BatchNorm_0`` of the classifiers' blocks,
``MinkowskiPointNet``'s ``{name}_scale``/``{name}_bias``, the VQ codebook
``params/…/embedding`` and the EMA quantizer's ``vq_stats`` (``steps``
kept int32), the dense UNets' 5-D conv kernels (transposed to ``[Cout,
Cin, k, k, k]``), GroupNorm/LayerNorm scales and the ``DenseAttention``
projections, standing alone or under a transformer's ``attn``.  And the
new entry points import neither JAX nor the JAX package.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import models as mm
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

CAP, B, EXT = 256, 2, 16


def _st(cin):
    return jax.eval_shape(
        lambda c, f, v: mt.sparse_tensor(c, f, capacity=CAP, valid=v,
                                         batch_size=B, extent=(EXT,) * 3),
        jnp.zeros((CAP, 4), jnp.int32), jnp.zeros((CAP, cin)),
        jnp.zeros(CAP, bool))


def _field():
    return mt.TensorField(coordinates=jnp.zeros((CAP, 4)),
                          features=jnp.zeros((CAP, 3)),
                          valid=jnp.zeros(CAP, bool), batch_size=B,
                          extent=(EXT,) * 3)


def _seed():
    return jax.eval_shape(lambda: mt.SparseTensor(grid=mt.SparseGrid(
        coords=jnp.zeros((B, 4), jnp.int32), valid=jnp.ones(B, bool),
        stride=(64,) * 3, batch_size=B, extent=(64,) * 3),
        features=jnp.zeros((B, 4))))


PL = (4, 8, 8, 8, 8, 8, 4, 4)
X, T, EHS = jnp.zeros((B, 8, 8, 8, 1)), jnp.zeros((B,), jnp.int32), \
    jnp.zeros((B, 1, 6))
CASES = {
    "minkunet14": lambda: (
        mm.MinkUNet14(out_channels=3, input_capacity=CAP, planes=PL,
                      init_dim=4),
        mp.models.MinkUNet14(3, planes=PL, init_dim=4, input_capacity=CAP,
                             device="cpu"), (_st(3),)),
    "minkunet50": lambda: (
        mm.MinkUNet50(out_channels=3, input_capacity=CAP, planes=PL,
                      init_dim=4),
        mp.models.MinkUNet50(3, planes=PL, init_dim=4, input_capacity=CAP,
                             device="cpu"), (_st(3),)),
    "minkfcnn": lambda: (
        mm.MinkowskiFCNN(out_channel=5, embedding_channel=16,
                         channels=(4, 6, 8, 8, 8), voxel_capacity=CAP),
        mp.models.MinkowskiFCNN(5, 16, (4, 6, 8, 8, 8), CAP, device="cpu"),
        (_field(),)),
    "minkpointnet": lambda: (
        mm.MinkowskiPointNet(out_channel=5, embedding_channel=16),
        mp.models.MinkowskiPointNet(5, 16, device="cpu"), (_field(),)),
    "pointnet": lambda: (
        mm.PointNet(out_channel=5, embedding_channel=16),
        mp.models.PointNet(5, 16, device="cpu"), (jnp.zeros((2, 10, 3)),)),
    "completion": lambda: (
        mm.CompletionNet(enc_channels=(4, 4, 8, 8, 8, 8),
                         dec_channels=(8, 8, 4, 4, 4, 4)),
        mp.models.CompletionNet(1, (4, 4, 8, 8, 8, 8), (8, 8, 4, 4, 4, 4),
                                device="cpu"), (_st(1), _st(1).grid)),
    "generative": lambda: (
        mm.GenerativeNet(channels=(8, 8, 8, 4, 4, 4, 4),
                         level_capacities=(8, 64, 128, 128, 128, 128)),
        mp.models.GenerativeNet(4, (8, 8, 8, 4, 4, 4, 4),
                                (8, 64, 128, 128, 128, 128), device="cpu"),
        (_seed(), _st(1).grid)),
    "vqvae": lambda: (
        mm.VQVAE(channels=(4, 8, 8, 8, 4), num_embeddings=16,
                 encoder_capacities=(128,) * 5, decoder_capacities=(128,) * 4),
        mp.models.VQVAE((4, 8, 8, 8, 4), 16, (128,) * 5, (128,) * 4,
                        device="cpu"), (_st(1), _st(1).grid)),
    "vqvae_ema": lambda: (
        mm.VQVAE(channels=(4, 8, 8, 8, 4), num_embeddings=16, ema=True,
                 encoder_capacities=(128,) * 5, decoder_capacities=(128,) * 4),
        mp.models.VQVAE((4, 8, 8, 8, 4), 16, (128,) * 5, (128,) * 4,
                        ema=True, device="cpu"), (_st(1), _st(1).grid)),
    "unet3d": lambda: (
        mm.UNet3DModel(block_channels=(8, 16), attn_levels=(1,), groups=4,
                       time_embedding_norm="scale_shift"),
        mp.models.UNet3DModel(block_channels=(8, 16), attn_levels=(1,),
                              groups=4, time_embedding_norm="scale_shift",
                              device="cpu"), (X, T)),
    "unet3d_no_time": lambda: (
        mm.UNet3DModel(block_channels=(8, 16), attn_levels=(1,), groups=4),
        mp.models.UNet3DModel(block_channels=(8, 16), attn_levels=(1,),
                              groups=4, time_embedding=False, device="cpu"),
        (X,)),
    "unet3d_cond": lambda: (
        mm.UNet3DConditionModel(out_channels=1, block_channels=(8, 16, 16),
                                cross_attention_dim=6, attention_head_dim=4,
                                groups=4),
        mp.models.UNet3DConditionModel(1, 1, (8, 16, 16), 2, 6, 4, 4,
                                       device="cpu"), (X, T, EHS)),
    "dense_attention": lambda: (
        mm.DenseAttention(num_heads=2, cross_attention_dim=6),
        mp.models.DenseAttention(8, 2, 6, device="cpu"),
        (jnp.zeros((B, 5, 8)), EHS)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_model_zoo_tree_lands_one_to_one(name):
    jmod, pmod, args = CASES[name]()
    abstract = jax.eval_shape(
        lambda *a: jmod.init(jax.random.PRNGKey(0), *a), *args)
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, 7, x.dtype) if x.dtype == jnp.int32 else
        rng.randn(*x.shape).astype(np.float32), abstract)
    load_flax(pmod, variables)  # raises unless one to one, shapes equal
    sd = pmod.state_dict()
    for name_, t in from_flax(variables, pmod).items():
        assert torch.equal(sd[name_], t.to(sd[name_].dtype)), name_
    if name == "vqvae_ema":
        assert sd["vq.steps"].dtype == torch.int32
        assert int(sd["vq.steps"]) == 7
        assert "vq_stats" in variables
    if name.startswith("unet3d"):
        k = np.asarray(variables["params"]["conv_in"]["kernel"])
        np.testing.assert_array_equal(sd["conv_in.weight"].numpy(),
                                      k.transpose(4, 3, 0, 1, 2))


def test_zoo_modules_import_no_jax():
    mods = ["classification", "segmentation", "reconstruction", "vqvae",
            "diffusion_dense", "cond"]
    code = ("import sys; " + "; ".join(
        f"import mink_octtree_stablediffusion_tpu_torch.train.{m}"
        for m in mods) + "; bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'flax' or m.startswith('flax.') or "
            "m.split('.')[0] == 'mink_octtree_stablediffusion_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True,
                       cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert r.returncode == 0, r.stdout + r.stderr
