"""The diffusion trainer's flags in the port against the JAX package, on the
CPU.

- ``ProceduralShapes``: the voxels, labels and captions of both splits,
  with and without composites, equal JAX's exactly (numpy on both sides).
- ``ops.union`` on bounded grids: the same set of rows as JAX's union and,
  row by row, the same summed features (1e-6·max|ref|); the port's rows
  in its canonical row-major order.  With an unbounded input: JAX's rows
  in (batch, Morton) order, row for row.
- ``inject_noise_points``: mode ``all``, ``noise_near`` without and with
  ``near_sigma`` (JAX's feature noise handed over cell by cell), and mode
  ``uniform`` with JAX's drawn points handed to the port: the port's rows
  equal JAX's rows inside the extent exactly (JAX keeps the neighbours
  outside it too, on an unbounded grid), the features within
  1e-6·max|ref|.
- ``factored_dims`` against optax's rule, and Adafactor
  (``adafactor_diffusion_optimizer``) against ``optax.chain(
  clip_by_global_norm(0.5), adafactor(...))`` over 3 updates on shapes
  [27, 160, 320] (factored over its two largest dimensions, where
  ``torch.optim.Adafactor`` would take the last two), [320], [4, 130]
  and [3, 3] (kept whole), the second update clipped: 1e-6·max|ref|.
- bf16 parameter storage (`test_train.py`'s cases): the master tracks a
  float32 run, the live parameters equal ``round(master)``, sub-ulp
  updates accumulate, the master starts from the float32 parameters, and
  a checkpoint of the state restores bit for bit.
- Remat: a UNet step with ``remat`` gives bit for bit the loss and
  gradients of the step without; the stacks draw nothing from a
  generator; the recompute's conv calls are marked as such.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src import factorized

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import diffusion as md
from mink_octtree_stablediffusion_tpu import train as mtrain
from mink_octtree_stablediffusion_tpu.data import datasets as jdata
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.train import generalize

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("split,composite,with_class", [
    ("train", 0.25, False), ("val", 1.0, True), ("test", 0.0, True)])
def test_procedural_shapes_match_jax(split, composite, with_class):
    kw = dict(resolution=32, num_samples=8, points_per_shape=600, seed=3,
              split=split, composite_prob=composite, with_class=with_class)
    ref = jdata.ProceduralShapes(**kw)
    got = mp.data.ProceduralShapes(**kw)
    for i in range(8):
        a, b = ref[i], got[i]
        assert set(a) == set(b)
        np.testing.assert_array_equal(b["coords"], a["coords"])
        np.testing.assert_array_equal(b["xyz"], a["xyz"])
        assert b["label"] == a["label"]
        assert b.get("caption") == a.get("caption")
    assert got._mix_seed(3, 1 << 24, 5) == ref._mix_seed(3, 1 << 24, 5)


def _latent(rng, b=2, res=8, stride=8, cap=96, c=4, n=20):
    """The same stride-``stride`` latent in both packages (``res`` cells a
    side)."""
    vox = [np.unique(rng.randint(0, res, (n, 3)), axis=0) * stride
           for _ in range(b)]
    cpad, vpad = mt.ops.pad_to_capacity(mt.ops.batched_coordinates_np(vox),
                                        cap)
    feats = (rng.randn(cap, c) * vpad[:, None]).astype(np.float32)
    kw = dict(capacity=cap, batch_size=b, stride=stride,
              extent=(res * stride,) * 3)
    jl = jax.jit(lambda co, f, v: mt.sparse_tensor(co, f, valid=v, **kw))(
        jnp.asarray(cpad), jnp.asarray(feats), jnp.asarray(vpad))
    pl = mp.sparse_tensor(_t(cpad), _t(feats), valid=_t(vpad), **kw)
    np.testing.assert_array_equal(_np(pl.grid.coords),
                                  np.asarray(jl.grid.coords))
    return jl, pl.with_features(_t(jl.features))


def _rows(coords, valid, feats, extent):
    """{coordinate tuple: features} of the valid rows inside ``extent``."""
    c, v, f = (np.asarray(a) for a in (coords, valid, feats))
    inside = v & np.all((c[:, 1:] >= 0) & (c[:, 1:] < np.asarray(extent)),
                        axis=1)
    return {tuple(r): x for r, x in zip(c[inside].tolist(), f[inside])}


def _same_rows(pst, jgrid, jfeats, extent):
    """The port's rows are JAX's rows inside ``extent``, in the port's
    canonical order, with the same features (1e-6·max|ref|)."""
    got = _rows(_np(pst.grid.coords), _np(pst.grid.valid), _np(pst.features),
                extent)
    ref = _rows(jgrid.coords, jgrid.valid, jfeats, extent)
    assert list(got) == sorted(got) and set(got) == set(ref)
    keys = sorted(ref)
    a = np.stack([got[k] for k in keys])
    b = np.stack([ref[k] for k in keys])
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-6 * max(np.abs(b).max(), 1.0))
    assert int(pst.grid.valid.sum()) == len(got)


def test_union_matches_jax(rng):
    ja, pa = _latent(rng, n=20)
    jb, pb = _latent(rng, n=30, cap=128)
    jg, jf = jax.jit(lambda a, b: mt.ops.union(
        [a.grid, b.grid], [a.features, b.features], 160))(ja, jb)
    pg, pf = mp.ops.union([pa.grid, pb.grid], [pa.features, pb.features],
                          160)
    assert pg.extent == jg.extent == (64,) * 3 and pg.capacity == 160
    _same_rows(mp.SparseTensor(grid=pg, features=pf), jg, jf, (64,) * 3)
    # the capacity defaults to the largest input's
    assert mp.ops.union([pa.grid, pb.grid],
                        [pa.features, pb.features])[0].capacity == 128
    # a mixed union (one input unbounded) is unbounded, in (batch, Morton)
    # order: row for row JAX's
    unbounded = mp.ops.SparseGrid(coords=pa.grid.coords, valid=pa.grid.valid,
                                  stride=pa.grid.stride, batch_size=2)
    jun = ja.grid.replace(extent=None)
    jg, jf = jax.jit(lambda a, u, b: mt.ops.union(
        [a.grid, u, b.grid], [a.features, a.features, b.features], 160))(
        ja, jun, jb)
    pg, pf = mp.ops.union([pa.grid, unbounded, pb.grid],
                          [pa.features, pa.features, pb.features], 160)
    assert pg.extent is None and jg.extent is None
    np.testing.assert_array_equal(_np(pg.coords), np.asarray(jg.coords))
    np.testing.assert_array_equal(_np(pg.valid), np.asarray(jg.valid))
    np.testing.assert_allclose(_np(pf), np.asarray(jf), rtol=0,
                               atol=1e-6 * max(np.abs(jf).max(), 1.0))


@pytest.mark.parametrize("mode,near,sigma", [
    ("all", False, None), ("none", True, None), ("all", True, 0.7),
    ("uniform", False, None)])
def test_inject_noise_points_matches_jax(rng, mode, near, sigma):
    jl, pl = _latent(rng)
    cap = 640 if mode == "uniform" else 2048  # no buffer overflows
    key = jax.random.PRNGKey(4)

    @jax.jit
    def ref(lat, key):
        return md.inject_noise_points(
            lat, key, mode, latent_resolution=8, noise_point_max=16,
            capacity=cap, noise_near=near,
            near_sigma=None if sigma is None else jnp.float32(sigma))
    jout = ref(jl, key)
    r_pts, r_feat = jax.random.split(key)
    extra = {}
    if mode == "uniform":  # JAX's draw (`noise_points.py:41`)
        extra["points"] = _t(jax.random.randint(r_pts, (2 * 16, 3), 0, 8))
    if sigma is not None:
        # JAX's feature noise on its (unbounded) near grid, carried to the
        # rows of the port's near grid by coordinate
        jnear = mt.ops.expand_grid(
            jl.grid, mt.ops.KernelSpec(3, 1, ndim=3).absolute_offsets(
                (8,) * 3), (8,) * 3, cap)
        noise = jax.random.normal(r_feat, (cap, 4))
        by_cell = {tuple(r): x for r, x, ok in zip(
            np.asarray(jnear.coords).tolist(), np.asarray(noise),
            np.asarray(jnear.valid)) if ok}
        pnear = mp.diffusion.noise_points._near_grid(pl, cap)
        extra["near_noise"] = _t(np.stack([
            by_cell.get(tuple(r), np.zeros(4, np.float32))
            for r in _np(pnear.coords).tolist()]).astype(np.float32))
    got = mp.diffusion.inject_noise_points(
        pl, mode, latent_resolution=8, noise_point_max=16, capacity=cap,
        noise_near=near, near_sigma=sigma, **extra)
    assert got.grid.extent == (64,) * 3 and got.capacity == cap
    _same_rows(got, jout.grid, jout.features, (64,) * 3)
    if near:  # JAX also keeps the neighbours outside the extent
        assert jout.grid.extent is None
        assert int(jout.grid.valid.sum()) > int(got.grid.valid.sum())


def test_inject_noise_points_draws_from_the_generator(rng):
    _, pl = _latent(rng)
    g = torch.Generator().manual_seed(1)
    a = mp.diffusion.inject_noise_points(pl, "uniform", 8, 16, capacity=640,
                                         noise_near=True, near_sigma=0.5,
                                         generator=g)
    g = torch.Generator().manual_seed(1)
    pts = mp.diffusion.uniform_points(g, 2, 16, 8)
    near = torch.randn((640, 4), generator=g)
    b = mp.diffusion.inject_noise_points(pl, "uniform", 8, 16, capacity=640,
                                         noise_near=True, near_sigma=0.5,
                                         points=pts, near_noise=near)
    assert torch.equal(a.grid.coords, b.grid.coords)
    assert torch.equal(a.features, b.features)
    assert mp.diffusion.inject_noise_points(pl, "none") is pl


@pytest.mark.parametrize("shape", [(27, 160, 320), (320,), (4, 130), (3, 3),
                                   (130, 200), (200, 130), (128, 5, 128)])
def test_factored_dims_match_optax(shape):
    assert mp.train.factored_dims(shape) == factorized._factored_dims(
        shape, True, 128)


def test_adafactor_matches_optax(rng):
    shapes = {"a": (27, 160, 320), "b": (320,), "c": (4, 130), "d": (3, 3)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    scales = (0.01, 1.0, 0.01)  # the second update's norm is clipped
    grads = [{n: (rng.randn(*s) * sc).astype(np.float32)
              for n, s in shapes.items()} for sc in scales]
    tx = mtrain.adafactor_diffusion_optimizer(1e-2, 1, 10)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(jp)
    tp = {n: torch.nn.Parameter(_t(v)) for n, v in params.items()}
    opt = mp.train.adafactor_diffusion_optimizer(list(tp.values()), 1e-2, 1,
                                                 10)
    for i, g in enumerate(grads):
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in tp.items():
            p.grad = _t(g[n])
        opt.step()
        for n in shapes:
            ref = np.asarray(jp[n])
            np.testing.assert_allclose(_np(tp[n]), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max(),
                                       err_msg=f"{n} update {i}")
    assert float(optax.global_norm(grads[1])) > 0.5
    st = opt.state[tp["a"]]
    assert st["v_row"].shape == (27, 160) and st["v_col"].shape == (27, 320)
    assert opt.state[tp["c"]]["v"].shape == (4, 130)
    assert opt.param_groups[0]["update_count"] == 3


class _Tiny(torch.nn.Module):
    """conv → BatchNorm → ELU → 1x1 conv → Dense on a fixed sparse input."""

    def __init__(self):
        super().__init__()
        self.conv = mp.nn.SparseConv(3, 8, kernel_size=3, device="cpu")
        self.bn = mp.nn.BatchNorm(8, device="cpu")
        self.head = mp.nn.SparseConv(8, 8, kernel_size=1, use_bias=True,
                                     device="cpu")
        self.out = mp.nn.Dense(8, 2, device="cpu")
        mp.nn.init_parameters(self, torch.Generator().manual_seed(0))


def _tiny_problem():
    rng = np.random.RandomState(0)
    vox = np.unique(rng.randint(0, 8, (60, 3)), axis=0)
    coords = mp.ops.batched_coordinates_np([vox])
    cpad, valid = mp.ops.pad_to_capacity(coords, 64)
    x = mp.sparse_tensor(_t(cpad), _t(rng.randn(64, 3).astype(np.float32)),
                         valid=_t(valid), extent=(8,) * 3)
    target = _t(rng.randn(64, 2).astype(np.float32))

    def loss_fn(m, batch):
        h = m.head(m.bn(m.conv(batch)))
        y = m.out(torch.nn.functional.elu(h.features))
        err = ((y - target) ** 2).sum(-1) * batch.valid
        return err.sum() / batch.valid.sum(), {}
    return x, loss_fn


def _master_equals_round(state):
    for p, m in zip(state.optimizer.params, state.optimizer.master):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(p, m.to(torch.bfloat16))


def test_mixed_precision_params_track_fp32():
    x, loss_fn = _tiny_problem()
    s32 = mp.train.TrainState(_Tiny(), None)
    s32.optimizer = torch.optim.Adam(s32.module.parameters(), lr=1e-2)
    s16 = mp.train.TrainState.create_mixed_precision(
        _Tiny(), lambda ps: torch.optim.Adam(ps, lr=1e-2))
    step = mp.train.make_train_step(loss_fn)
    l32, l16 = [], []
    for _ in range(20):
        l32.append(float(step(s32, x)[0]))
        l16.append(float(step(s16, x)[0]))
    np.testing.assert_allclose(l16, l32, rtol=2e-2)
    assert l16[-1] < 0.9 * l16[0]
    _master_equals_round(s16)
    assert all(b.dtype == torch.float32 for b in s16.module.buffers())


def test_mixed_precision_master_accumulates_sub_ulp_updates():
    w = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    opt = mp.train.MixedPrecisionParams(
        [w], lambda ps: torch.optim.SGD(ps, lr=1e-5))
    for _ in range(1000):
        opt.zero_grad()
        w.grad = torch.ones(4, dtype=torch.bfloat16)
        opt.step()
    np.testing.assert_allclose(_np(opt.master[0]), 1.0 - 1e-2, rtol=1e-3)
    assert float(w.detach()[0]) < 1.0


def test_create_mixed_precision_seeds_master_from_fp32(tmp_path):
    ref = _Tiny()
    state = mp.train.TrainState.create_mixed_precision(
        _Tiny(), lambda ps: mp.train.diffusion_optimizer(ps, 1e-2, 1, 10))
    for (name, p0), live, m in zip(ref.named_parameters(),
                                   state.module.parameters(),
                                   state.optimizer.master):
        assert torch.equal(m, p0), name
        assert torch.equal(live, p0.to(torch.bfloat16)), name
    # a checkpoint of the state (master and inner state) restores exactly
    x, loss_fn = _tiny_problem()
    step = mp.train.make_train_step(loss_fn)
    step(state, x)
    step(state, x)
    ckpt = mp.train.CheckpointManager(str(tmp_path / "mp"))
    ckpt.save(2, state)
    fresh = mp.train.TrainState.create_mixed_precision(
        _Tiny(), lambda ps: mp.train.diffusion_optimizer(ps, 1e-2, 1, 10))
    ckpt.restore(fresh)
    assert fresh.step == 2
    for a, b in zip(fresh.optimizer.master, state.optimizer.master):
        assert torch.equal(a, b)
    for a, b in zip(fresh.module.parameters(), state.module.parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert fresh.optimizer.param_groups[0]["update_count"] == 2
    _master_equals_round(fresh)


RES, B = 32, 2


def _canvas_unet(remat):
    return generalize.canvas_unet(
        unet_channel=(4, 8, 8, 8), batch_size=B, resolution=RES, group=4,
        remat=remat, device="cpu", seed=5)


def _unet_step(unet, latent, record=False):
    from mink_octtree_stablediffusion_tpu_torch.nn import record_routes
    unet.train()
    unet.zero_grad(set_to_none=True)
    t = torch.tensor([3, 800], dtype=torch.int32)
    noise = torch.randn(latent.features.shape,
                        generator=torch.Generator().manual_seed(2))
    with record_routes() as routes:
        loss, _ = mp.diffusion.diffusion_training_loss(
            unet, mp.diffusion.DDPMScheduler.create(), latent,
            prediction_type="v_prediction", timesteps=t, noise=noise)
        loss.backward()
    return loss, {n: p.grad.clone() for n, p in unet.named_parameters()}, \
        routes


def _canvas_latent():
    canvas = mp.ops.canvas_grid(B, RES, 8, device="cpu")
    f = torch.randn(canvas.capacity, 4,
                    generator=torch.Generator().manual_seed(1))
    return mp.SparseTensor(grid=canvas, features=f)


def test_unet_remat_is_bit_equal_and_draws_nothing():
    latent = _canvas_latent()
    l0, g0, r0 = _unet_step(_canvas_unet(False), latent)
    unet = _canvas_unet(True)
    draws = []

    class _Draws(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")
            if "generator" in kwargs or any(
                    w in name for w in ("rand", "normal", "bernoulli",
                                        "dropout", "multinomial")):
                draws.append(name)
            return func(*args, **kwargs)
    stacks = [m for m in unet.modules()
              if isinstance(m, mp.nn.ResNetStack)]
    mode = _Draws()

    def enter(*_):
        mode.__enter__()

    def leave(*_):
        mode.__exit__(None, None, None)
    hooks = [h for m in stacks for h in (m.register_forward_pre_hook(enter),
                                         m.register_forward_hook(leave))]
    l1, g1, r1 = _unet_step(unet, latent)
    for h in hooks:
        h.remove()
    assert torch.equal(l0, l1)
    assert set(g0) == set(g1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert not draws, draws
    # every stack ran twice: its convs again, marked as the recompute
    assert not any(r.recompute for r in r0)
    fresh = [r for r in r1 if not r.recompute]
    assert [r[:8] for r in fresh] == [r[:8] for r in r0]
    again = [r for r in r1 if r.recompute]
    assert 0 < len(again) < len(fresh)
