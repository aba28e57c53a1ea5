"""The port's VQ-VAE and the VQ-VAE entry point against the JAX package, on
the CPU, float32.

- ``VectorQuantizer``, codebook-gradient form: the straight-through
  output and the loss within 1e-5, the code indices exactly, and the
  gradients of the encoder rows and of the codebook within 1e-4·max|ref|.
- EMA form: the buffers (``embedding``, ``cluster_size``, ``ema_sum``,
  ``steps``; JAX's ``vq_stats``) after two train steps within 1e-5, each
  step quantizing with the book from before its update; with
  ``restart_dead`` on a batch with one valid row, so that both packages
  re-seed every dead code with that row whatever their draws; ``.eval()``
  moves no buffer.
- ``VQVAE`` at narrow widths, both forms: one train step of
  `examples/train_vqvae.py`'s loss (per-level BCE + the VQ loss), the
  loss within 1e-5 relative, the indices exactly, every gradient within
  1e-4·max|ref| of that tensor's ``jax.value_and_grad`` (the encoder's
  unused log-variance head: zero in JAX, none in the port), the running
  statistics and the EMA buffers after the step; then, in EMA form, eval
  mode from those statistics (latent, codes, level-0 logits; no buffer
  moves).
- ``train.vqvae`` for 2 steps with ``--device cpu``, resumed from its
  checkpoint.
(The quantizer's ``process_group`` is a job of `test_torch_parallel.py`'s
two-rank spawn.)
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import models as mm
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.train import vqvae as tv
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

torch.set_num_threads(1)
REL = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)
K, D, N = 16, 4, 64


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=REL * max(np.abs(ref).max(), 1e-30),
                               err_msg=err_msg)


def _latent(rng, n_valid=N - 9, scale=0.1):
    """A latent-like tensor in both packages: ``n_valid`` valid rows."""
    coords = np.zeros((N, 4), np.int32)
    coords[:, 1] = np.arange(N)
    valid = np.arange(N) < n_valid
    feats = (rng.randn(N, D) * scale * valid[:, None]).astype(np.float32)
    jg = mt.SparseGrid(coords=jnp.asarray(coords), valid=jnp.asarray(valid),
                       stride=(8, 8, 8), batch_size=1)
    pg = mp.SparseGrid(coords=_t(coords), valid=_t(valid), stride=(8, 8, 8),
                       batch_size=1)
    return (mt.SparseTensor(grid=jg, features=jnp.asarray(feats)),
            mp.SparseTensor(grid=pg, features=_t(feats)))


def _book(rng):
    return (rng.uniform(-0.15, 0.15, (K, D))).astype(np.float32)


def test_vector_quantizer_matches_jax(rng):
    jze, pze = _latent(rng)
    book = _book(rng)
    gout = rng.randn(N, D).astype(np.float32)
    jvq = mm.VectorQuantizer(K, D)

    def f(emb, feats):
        out, idx, loss = jvq.apply({"params": {"embedding": emb}},
                                   jze.replace(features=feats))
        return jnp.vdot(out.features, gout) + loss, (out.features, idx, loss)

    (_, (ref, ridx, rloss)), (gemb, gfeat) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(book), jze.features)
    pvq = mp.models.VectorQuantizer(K, D, device="cpu")
    load_flax(pvq, {"params": {"embedding": book}})
    feats = pze.features.clone().requires_grad_()
    out, idx, loss = pvq(pze.with_features(feats))
    ((out.features * _t(gout)).sum() + loss).backward()
    np.testing.assert_array_equal(_np(idx), np.asarray(ridx))
    assert len(np.unique(np.asarray(ridx))) > 4
    np.testing.assert_allclose(_np(out.features), np.asarray(ref), **TOL)
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)
    _close(feats.grad, gfeat)
    _close(pvq.embedding.grad, gemb)


@pytest.mark.parametrize("restart", [False, True])
def test_vq_ema_two_steps_match_jax(rng, restart):
    """Two train steps, the second from the first's buffers; with
    ``restart_dead`` (decay 0.5, floor 0.6: the codes no row picks die at
    the first step) on one valid row."""
    kw = dict(ema=True, ema_decay=0.5 if restart else 0.9,
              restart_dead=restart, dead_floor=0.6)
    book = _book(rng)
    stats = {"embedding": jnp.asarray(book),
             "cluster_size": jnp.asarray(rng.rand(K).astype(np.float32) +
                                         0.5),
             "ema_sum": jnp.asarray(book * 1.3), "steps": jnp.zeros(
                 (), jnp.int32)}
    jvq = mm.VectorQuantizer(K, D, **kw)
    pvq = mp.models.VectorQuantizer(K, D, **kw, device="cpu")
    load_flax(pvq, {"vq_stats": stats})
    pvq.train()
    gen = torch.Generator().manual_seed(0)
    step = jax.jit(lambda s, x: jvq.apply({"vq_stats": s}, x, train=True,
                                          mutable=["vq_stats"]))
    for i in range(2):
        jze, pze = _latent(rng, n_valid=1 if restart else N - 9)
        (ref, ridx, rloss), upd = step(stats, jze)
        stats = upd["vq_stats"]
        out, idx, loss = pvq(pze, gen)
        np.testing.assert_array_equal(_np(idx), np.asarray(ridx))
        np.testing.assert_allclose(_np(out.features),
                                   np.asarray(ref.features), **TOL)
        np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)
        for name, want in from_flax({"vq_stats": stats}).items():
            got = dict(pvq.named_buffers())[name]
            assert got.dtype == want.dtype, name
            np.testing.assert_allclose(_np(got), want.numpy(), **TOL,
                                       err_msg=f"step {i + 1} {name}")
    assert int(pvq.steps) == 2
    if restart:  # every dead code holds the one valid row
        row = _np(pze.features)[0]
        dead = _np(pvq.cluster_size) == 1.0
        assert dead.sum() > K // 2
        np.testing.assert_array_equal(_np(pvq.embedding)[dead],
                                      np.tile(row, (int(dead.sum()), 1)))
    before = {n: b.clone() for n, b in pvq.named_buffers()}
    pvq.eval()
    pvq(_latent(rng)[1])
    for n, b in pvq.named_buffers():
        assert torch.equal(b, before[n]), n


def test_restart_dead_needs_a_generator(rng):
    pvq = mp.models.VectorQuantizer(K, D, ema=True, restart_dead=True,
                                    device="cpu")
    pvq.train()
    with pytest.raises(ValueError, match="generator"):
        pvq(_latent(rng)[1])


RES, B, CAP = 16, 2, 512
VCH, ENC, DEC = (4, 8, 8, 8, 4), (256, 128, 64, 64, 64), (64, 128, 256, 512)


@pytest.mark.parametrize("ema", [False, True])
def test_vqvae_step_matches_jax(rng, ema):
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=2,
                                 points_per_shape=600)
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(B)], CAP)
    jnet = mm.VQVAE(channels=VCH, num_embeddings=K, encoder_capacities=ENC,
                    decoder_capacities=DEC, ema=ema)
    pnet = mp.models.VQVAE(VCH, K, ENC, DEC, ema=ema, device="cpu")

    def build(cpad, valid):
        return mt.sparse_tensor(cpad, jnp.ones((CAP, 1)) * valid[:, None],
                                capacity=CAP, batch_size=B, valid=valid,
                                extent=(RES,) * 3)

    jb = (jnp.asarray(cpad), jnp.asarray(valid))
    st0 = jax.eval_shape(build, *jb)
    abstract = jax.eval_shape(lambda x: jnet.init(jax.random.PRNGKey(0), x,
                                                  x.grid), st0)

    def draw(path, x):
        key = str(path[-1].key)
        if key == "steps":
            return jnp.zeros(x.shape, x.dtype)
        std = 0.3
        if key == "kernel":
            std = np.sqrt(2.0 / (x.shape[0] * x.shape[1]))
        if key in ("embedding", "ema_sum"):
            std = 0.5
        a = rng.randn(*x.shape).astype(np.float32) * std
        if key in ("var", "cluster_size"):
            a = np.abs(a) + 0.5
        return jnp.asarray(a)
    variables = jax.tree_util.tree_map_with_path(draw, abstract)
    load_flax(pnet, variables)
    frozen = {c: v for c, v in variables.items() if c != "params"}

    def loss_fn(params):  # examples/train_vqvae.py
        st = build(*jb)
        (out_clss, targets, _, _, idx, vq_loss), upd = jnet.apply(
            {"params": params, **frozen}, st, st.grid,
            mutable=list(frozen))
        bce = 0.0
        for logits_t, target in zip(out_clss, targets):
            lo = logits_t.features[:, 0]
            v = logits_t.valid
            t = target.astype(lo.dtype)
            per = jnp.maximum(lo, 0.) - lo * t + \
                jnp.log1p(jnp.exp(-jnp.abs(lo)))
            bce += jnp.sum(jnp.where(v, per, 0.)) / jnp.maximum(
                jnp.sum(v.astype(lo.dtype)), 1.)
        bce = bce / len(out_clss)
        return bce + vq_loss, (idx, upd)

    (loss, (ridx, upd)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    pnet.train()
    idx = []
    hook = pnet.vq.register_forward_hook(lambda m, i, o: idx.append(o[1]))
    ploss, aux = tv.build_loss_fn(input_capacity=CAP, batch_size=B,
                                  resolution=RES, device="cpu")(
        pnet, (cpad, valid))
    hook.remove()
    ploss.backward()
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-5)
    np.testing.assert_array_equal(_np(idx[0]), np.asarray(ridx))
    named = dict(pnet.named_parameters())
    ref_grads = from_flax({"params": grads})
    assert set(ref_grads) == set(named)
    for name, ref in ref_grads.items():
        got = named[name].grad
        if name.startswith("encoder.log_var_conv."):
            assert got is None and not np.any(ref.numpy())
            continue
        _close(got, ref.numpy(), err_msg=name)
    buffers = dict(pnet.named_buffers())
    for name, want in from_flax(upd).items():
        _close(buffers[name], want.numpy(), err_msg=name)
    if not ema:
        return
    # eval mode from the stepped statistics: the level-0 logits, the codes,
    # and no buffer moves
    state = {**frozen, **upd}
    (rcls, _, _, rze, ridx, _), _ = jax.jit(lambda p, s: jnet.apply(
        {"params": p, **s}, build(*jb), build(*jb).grid, train=False,
        mutable=list(s)))(variables["params"], state)
    pnet.load_state_dict(from_flax({"params": variables["params"], **state},
                                   pnet))
    pnet.eval()
    before = {n: b.clone() for n, b in pnet.named_buffers()}
    st = mp.sparse_tensor(_t(cpad), _t(valid)[:, None].float(), capacity=CAP,
                          batch_size=B, valid=_t(valid), extent=(RES,) * 3)
    with torch.no_grad():
        pcls, _, _, pze, pidx, _ = pnet(st, st.grid)
    _close(pze.features, rze.features)
    np.testing.assert_array_equal(_np(pidx), np.asarray(ridx))
    _close(pcls[0].features, rcls[0].features)
    for n, b in pnet.named_buffers():
        assert torch.equal(b, before[n]), n


def test_train_vqvae_entry_point(tmp_path, capsys):
    argv = ["--device", "cpu", "--resolution", "32", "--input_capacity",
            "2048", "--vae_channel", "4", "8", "8", "8", "4",
            "--num_embeddings", "16", "--steps", "2", "--ckpt_dir",
            str(tmp_path / "ck")]
    out = tv.main(argv)
    assert out["step"] == 2 and np.isfinite(out["final_loss"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        out
    argv[argv.index("--steps") + 1] = "3"  # resumes at step 2
    assert tv.main(argv)["step"] == 3
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000002.pt", "step_00000003.pt"]
