"""Data parallelism of the port (`parallel/`, `train.make_dp_train_step`,
SyncBN) against the JAX package, on the CPU.

The port's ranks are two processes (``torch.multiprocessing.spawn``,
`torch_dp_worker.py`, which imports no JAX) in a gloo group over loopback
``tcp://``; JAX's are a 2-device sub-mesh of the 8-device CPU mesh that
`conftest.py` sets up.  Both start from the same weights (the port's,
carried into flax through ``utils.convert``'s name map), and each rank
gets a different batch and JAX's draws for its device (JAX's
``split_device_rngs`` keys, handed over as arrays).

- SyncBN (`nn.BatchNorm(process_group=…)`) on rows whose valid counts
  differ per rank against ``BatchNorm(axis_name="data")`` under
  ``shard_map``: outputs, gradients and running statistics at 1e-5.
- One DP step of the SyncBN VAE of `tests/test_train.py::
  test_dp_vae_step_matches_single` (``channels=(4, 8, 8, 8, 2)``,
  resolution 16, the canvas latent; occupancy heads ×100 so that no top-k
  decision lies within float32 noise of its threshold) against
  ``make_dp_train_step`` (its loss divided by the device count: see
  ``N_DEV``): the loss within rtol 1e-5, the parameters after
  Adam within rtol 1e-3 / atol 5e-5 (JAX's own bound for this step: Adam's
  first step normalises each gradient element, which amplifies float32
  reassociation on elements near zero), the batch statistics within rtol
  1e-4 / atol 1e-5; the two ranks bit for bit equal.
- The same under bf16 parameter storage, on a narrow SyncBN ResNet14
  against ``TrainState.create_mixed_precision``: the float32 masters
  within the same bound, the live bf16 weights ``round(master)``.
- ``parallel.param_spec`` on the cases of `test_parallel_tp.py`, and a
  two-process ``all_reduce`` / ``broadcast`` / differentiable sum.
- DP sampling and JAX's other dry-run phases (``parallel.dryrun``).
- The EMA ``VectorQuantizer`` with a ``process_group`` (two steps, the
  ranks' valid rows differing) against ``axis_name="data"``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import models as mm
from mink_octtree_stablediffusion_tpu import train as mtrain
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.parallel import dryrun
from mink_octtree_stablediffusion_tpu_torch.utils import convert
from mink_octtree_stablediffusion_tpu_torch.utils.convert import from_flax

import torch_dp_worker

torch.set_num_threads(1)

RES, CAP, B = 16, 256, 2
VCH, ENC, DEC = (4, 8, 8, 8, 2), (128, 64, 32, 32, 32), (16, 64, 128, 256)
RCAP, PLANES, INIT = 1024, (4, 8, 8, 8), 4
# JAX's steps take the loss over N_DEV: under JAX 0.9's ``shard_map``
# the gradient of a replicated parameter is already summed over the
# devices, and ``make_dp_train_step``'s ``pmean`` of that sum leaves it a
# sum, so the step takes the gradient of the devices' summed losses.  The
# port takes the mean (``all_reduce`` then divide), the gradient of the
# mean loss; loss / N_DEV makes JAX's sum that mean.
N_DEV = 2


def _flax_from_port(abstract, module):
    """A flax tree shaped like ``abstract`` holding ``module``'s weights."""
    sd = module.state_dict()

    def leaf(collection):
        def fn(path, x):
            names = tuple(str(p.key) for p in path)
            name, _ = convert._translate(collection, names,
                                         np.zeros(x.shape, np.float32))
            w = sd[name].numpy()
            return jnp.asarray(w.T if names[-1] == "kernel" and w.ndim == 2
                               else w)
        return fn
    return {c: jax.tree_util.tree_map_with_path(leaf(c), tree)
            for c, tree in abstract.items()}


def _rows(seed, n):
    """A batch of B random voxel sets at RES, ``n`` draws an instance."""
    r = np.random.RandomState(seed)
    vox = [np.unique(r.randint(0, RES, (n, 3)), axis=0) for _ in range(B)]
    cpad, valid = mp.ops.pad_to_capacity(
        mp.ops.batched_coordinates_np(vox), CAP)
    return cpad, valid, (np.ones((CAP, 1), np.float32) * valid[:, None])


def _stack(batches):
    return tuple(jnp.asarray(np.stack([b[i] for b in batches]))
                 for i in range(len(batches[0])))


def _vae_case():
    """JAX's DP step and the port's inputs for it."""
    batches = [_rows(10, 96), _rows(11, 60)]  # valid rows differ per rank
    assert batches[0][1].sum() != batches[1][1].sum()
    cells = (RES // 8) ** 3
    pvae = mp.models.VAE(channels=VCH, encoder_capacities=ENC,
                         decoder_capacities=DEC, latent_canvas=True,
                         device="cpu", seed=0)
    with torch.no_grad():
        for lvl in range(1, 5):
            getattr(pvae.decoder, f"block{lvl}_cls").kernel.mul_(100.0)
    jvae = mm.VAE(channels=VCH, encoder_capacities=ENC,
                  decoder_capacities=DEC, latent_canvas=True,
                  axis_name="data")

    def build(cpad, valid, feats):
        return mt.sparse_tensor(cpad, feats, capacity=CAP, batch_size=B,
                                valid=valid, extent=(RES,) * 3)

    def loss_fn(params, batch_stats, batch, rng):
        st = build(*batch)
        (clss, tgts, _, mean, log_var, _), upd = jvae.apply(
            {"params": params, "batch_stats": batch_stats}, st, st.grid,
            rng, mutable=["batch_stats"])
        loss, aux = mm.vae_loss(clss, tgts, mean, log_var, 1e-6)
        return loss / N_DEV, (aux, upd["batch_stats"])

    st0 = build(*(jnp.asarray(a) for a in batches[0]))
    k = jax.random.PRNGKey(0)
    abstract = jax.eval_shape(jvae.init, k, st0, st0.grid, k)
    variables = _flax_from_port(abstract, pvae)
    state = mtrain.TrainState.create(variables["params"],
                                     variables["batch_stats"],
                                     optax.adam(1e-3))
    rngs = jax.random.split(jax.random.PRNGKey(1), 2)
    s2, loss, aux = mtrain.make_dp_train_step(
        loss_fn, mt.parallel.data_parallel_mesh(2))(state, _stack(batches),
                                                     rngs)
    draws = [jax.random.split(r) for r in rngs]  # `models/vae.py:160`
    job = {"cfg": {"channels": VCH, "enc": ENC, "dec": DEC, "cap": CAP,
                   "b": B, "res": RES},
           "state": {n: t.numpy() for n, t in pvae.state_dict().items()},
           "batches": batches,
           "eps": [np.asarray(jax.random.normal(e, (ENC[2], VCH[4])))
                   for e, _ in draws],
           "canvas_noise": [np.asarray(jax.random.normal(
               c, (B * cells, VCH[4]))) for _, c in draws]}
    ref = {"loss": float(loss) * N_DEV,
           "aux": {k: float(v) for k, v in aux.items()},
           "params": from_flax({"params": s2.params}),
           "stats": from_flax({"batch_stats": s2.batch_stats})}
    return job, ref


def _resnet_case():
    """JAX's DP step of a narrow SyncBN ResNet14 under bf16 storage."""
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=8,
                                 points_per_shape=512)
    batches = []
    for r in range(2):
        samples = [ds[2 * r + i] for i in range(B)]
        cpad, valid, feats, _ = mp.data.collate_pointclouds(
            [s["coords"] for s in samples], RCAP)
        batches.append((cpad, valid, feats,
                        np.array([s["label"] for s in samples])))
    pnet = mp.models.ResNet14(out_channels=4, planes=PLANES, init_dim=INIT,
                              input_capacity=RCAP, device="cpu", seed=1)
    jnet = mm.ResNet14(out_channels=4, planes=PLANES, init_dim=INIT,
                       input_capacity=RCAP, axis_name="data")

    def build(cpad, valid, feats):
        return mt.sparse_tensor(cpad, feats, capacity=RCAP, batch_size=B,
                                valid=valid, extent=(RES,) * 3)

    def loss_fn(params, batch_stats, batch, rng):
        cpad, valid, feats, labels = batch
        logits, upd = jnet.apply(
            {"params": params, "batch_stats": batch_stats},
            build(cpad, valid, feats), mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        return loss / N_DEV, ({}, upd["batch_stats"])

    st0 = build(*(jnp.asarray(a) for a in batches[0][:3]))
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), st0)
    variables = _flax_from_port(abstract, pnet)
    state = mtrain.TrainState.create_mixed_precision(
        variables["params"], variables["batch_stats"],
        mtrain.mixed_precision_params(optax.adam(1e-3)))
    s2, loss, _ = mtrain.make_dp_train_step(
        loss_fn, mt.parallel.data_parallel_mesh(2))(
        state, _stack(batches), jax.random.split(jax.random.PRNGKey(2), 2))
    job = {"cfg": {"planes": PLANES, "init_dim": INIT, "cap": RCAP, "b": B,
                   "res": RES},
           "state": {n: t.numpy() for n, t in pnet.state_dict().items()},
           "batches": batches}
    ref = {"loss": float(loss) * N_DEV,
           "master": from_flax({"params": s2.opt_state.master}),
           "stats": from_flax({"batch_stats": s2.batch_stats})}
    return job, ref


def _sync_bn_case(rng):
    """SyncBN on two ranks whose valid rows differ, against JAX."""
    c = 5
    tensors, jsts = [], []
    for n in (150, 90):
        coords = []
        for b in range(B):
            v = np.unique(rng.randint(0, 10, (n, 3)), axis=0)
            coords.append(np.concatenate(
                [np.full((len(v), 1), b, np.int32), v], 1))
        cpad, valid = mp.ops.pad_to_capacity(np.concatenate(coords), 512)
        feats = (rng.randn(512, c) * 2.0 + 1.0) * valid[:, None]
        tensors.append((cpad, valid, feats.astype(np.float32)))
    job = {"scale": (rng.rand(c) + 0.5).astype(np.float32),
           "bias": rng.randn(c).astype(np.float32), "extent": 10,
           "tensors": tensors,
           "gout": [rng.randn(512, c).astype(np.float32) for _ in range(2)]}
    bn = mt.nn.BatchNorm(axis_name="data")
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

    def dev(params, cpad, valid, feats, gout):
        # the affine parameters enter per device (stacked, sharded), so that
        # their gradients are each device's own, before any mean
        params = jax.tree.map(lambda p: p[0], params)
        st = mt.sparse_tensor(cpad[0], feats[0], capacity=512, batch_size=B,
                              valid=valid[0], extent=(10,) * 3)

        def f(params, x):
            y, upd = bn.apply({"params": params, "batch_stats": stats},
                              st.replace(features=x), train=True,
                              mutable=["batch_stats"])
            return jnp.vdot(y.features, gout[0]), (y.features,
                                                   upd["batch_stats"])
        (_, (y, upd)), (dp, df) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, st.features)
        dp = jax.tree.map(lambda g: g[None], dp)
        return y[None], df[None], dp, upd

    fn = jax.jit(shard_map(
        dev, mesh=mt.parallel.data_parallel_mesh(2),
        in_specs=(P("data"),) * 5,
        out_specs=(P("data"), P("data"), P("data"), P())))
    params = {k: jnp.asarray(np.stack([job[k]] * 2))
              for k in ("scale", "bias")}
    y, df, dp, upd = fn(params, *_stack(tensors), jnp.asarray(
        np.stack(job["gout"])))
    ref = {"y": np.asarray(y), "df": np.asarray(df),
           "dscale": np.asarray(dp["scale"]), "dbias": np.asarray(dp["bias"]),
           "mean": np.asarray(upd["mean"]), "var": np.asarray(upd["var"])}
    return job, ref


def _vq_case(rng):
    """The EMA quantizer over two ranks whose valid rows differ, against
    ``VectorQuantizer(axis_name="data")`` under ``shard_map``: two steps."""
    k, d, n = 8, 3, 40
    book = rng.uniform(-0.3, 0.3, (k, d)).astype(np.float32)
    stats = {"embedding": book, "cluster_size": (rng.rand(k) + 0.5).astype(
        np.float32), "ema_sum": book * 1.2, "steps": np.zeros((), np.int32)}
    latents = []
    for _ in range(2):
        valid = [np.arange(n) < m for m in (31, 17)]
        latents.append(([(rng.randn(n, d) * 0.3 * v[:, None]).astype(
            np.float32) for v in valid], valid))
    vq = mm.VectorQuantizer(k, d, ema=True, axis_name="data")

    def dev(stats, feats, valid):
        grid = mt.SparseGrid(coords=jnp.zeros((n, 4), jnp.int32),
                             valid=valid[0], stride=(8, 8, 8), batch_size=1)
        (_, idx, _), upd = vq.apply(
            {"vq_stats": stats}, mt.SparseTensor(grid=grid,
                                                 features=feats[0]),
            train=True, mutable=["vq_stats"])
        return idx[None], upd["vq_stats"]

    fn = jax.jit(shard_map(dev, mesh=mt.parallel.data_parallel_mesh(2),
                           in_specs=(P(), P("data"), P("data")),
                           out_specs=(P("data"), P())))
    js = {key: jnp.asarray(v) for key, v in stats.items()}
    idx = []
    for feats, valid in latents:
        i, js = fn(js, jnp.asarray(np.stack(feats)),
                   jnp.asarray(np.stack(valid)))
        idx.append(np.asarray(i))
    job = {"k": k, "d": d, "stats": stats, "latents": latents}
    return job, {"idx": idx, "state": from_flax({"vq_stats": js})}


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """JAX's references, then one spawn of two port ranks running every
    job; → (references, per-rank results)."""
    rng = np.random.RandomState(0)
    jobs, refs = {}, {}
    for name, case in (("sync_bn", lambda: _sync_bn_case(rng)),
                       ("vae_step", _vae_case),
                       ("resnet_bf16_step", _resnet_case),
                       ("dp_sampling", lambda: ({}, None)),
                       ("vq_ema", lambda: _vq_case(rng))):
        jobs[name], refs[name] = case()
    out = str(tmp_path_factory.mktemp("dp"))
    torch.multiprocessing.start_processes(
        torch_dp_worker.run,
        args=(2, mp.parallel.free_port(), jobs, out), nprocs=2, join=True,
        start_method="spawn")
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return refs, ranks


def test_param_spec_rules():
    spec = mp.parallel.param_spec
    assert spec((27, 8, 16), 4) == Shard(2)
    assert spec((8, 16), 4) == Shard(1)
    assert spec((16,), 4) == Replicate()
    # non-divisible or too-small dims stay replicated
    assert spec((27, 8, 6), 4) == Replicate()
    assert spec((27, 8, 4), 4) == Replicate()


def test_two_process_collectives(dp_run):
    """all_reduce and broadcast across the process boundary, the
    differentiable sum's backward (the sum of the ranks' cotangents), each
    rank's row of a ``stack_devices`` batch (``shard_batch``), and the
    data groups (all ranks: the default group; the first rank alone)."""
    _, ranks = dp_run
    for r, res in enumerate(ranks):
        got = res["collectives"]
        np.testing.assert_array_equal(got["all_reduce"], [3.0] * 3)
        np.testing.assert_array_equal(got["broadcast"], [10.0] * 2)
        np.testing.assert_array_equal(got["sum"], [6.0] * 2)
        # d/dz_r of Σ_q (q+1)·Σ_p 2 z_p = 2·(1 + 2)
        np.testing.assert_array_equal(got["sum_grad"], [6.0] * 2)
        np.testing.assert_array_equal(got["shard"][0], np.full((2, 4), r))
        np.testing.assert_array_equal(got["shard"][1],
                                      np.full((2, 1), 10.0 * r))
        assert got["world_is_default"]
        assert not got["jax_imported"]  # the ranks never import JAX
    assert ranks[0]["collectives"]["sub_size"] == 1


def test_sync_batchnorm_matches_jax(dp_run):
    refs, ranks = dp_run
    ref = refs["sync_bn"]
    for r, res in enumerate(ranks):
        got = res["sync_bn"]
        for key in ("y", "df", "dscale", "dbias"):
            np.testing.assert_allclose(got[key], ref[key][r], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{key} rank {r}")
        for key in ("mean", "var"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_dp_vae_step_loss_matches_jax(dp_run):
    refs, ranks = dp_run
    ref = refs["vae_step"]
    for res in ranks:
        np.testing.assert_allclose(res["vae_step"]["loss"], ref["loss"],
                                   rtol=1e-5)
        for key in ("bce", "kld"):
            np.testing.assert_allclose(res["vae_step"]["aux"][key],
                                       ref["aux"][key], rtol=1e-5)


def test_dp_vae_step_params_match_jax(dp_run):
    refs, ranks = dp_run
    state = ranks[0]["vae_step"]["state"]
    for name, want in refs["vae_step"]["params"].items():
        np.testing.assert_allclose(state[name], want.numpy(), rtol=1e-3,
                                   atol=5e-5, err_msg=name)


def test_dp_vae_step_batch_stats_match_jax(dp_run):
    refs, ranks = dp_run
    state = ranks[0]["vae_step"]["state"]
    stats = refs["vae_step"]["stats"]
    assert stats
    for name, want in stats.items():
        np.testing.assert_allclose(state[name], want.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_dp_ranks_agree_bit_for_bit(dp_run):
    """Both ranks end the step with the same parameters and buffers, and
    the step reports its collective payload."""
    _, (a, b) = dp_run
    for job in ("vae_step", "resnet_bf16_step"):
        key = "state" if job == "vae_step" else "live"
        assert a[job]["loss"] == b[job]["loss"]
        for name, t in a[job][key].items():
            np.testing.assert_array_equal(t, b[job][key][name],
                                          err_msg=f"{job} {name}")
    # the float32 gradients, the has-gradient flags, the metrics and the
    # running statistics: more than the parameters and buffers
    assert a["vae_step"]["comm"]["bytes"] > 4 * sum(
        t.size for t in a["vae_step"]["state"].values())


def test_dp_bf16_storage_matches_jax(dp_run):
    """bf16 parameter storage: the ranks' float32 mean reaches the master
    unrounded; masters and batch statistics against JAX, live = round(
    master)."""
    refs, ranks = dp_run
    ref = refs["resnet_bf16_step"]
    got = ranks[0]["resnet_bf16_step"]
    assert got["live_dtypes"] == ["torch.bfloat16"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert set(got["master"]) == set(ref["master"])
    for name, want in ref["master"].items():
        np.testing.assert_allclose(got["master"][name], want.numpy(),
                                   rtol=1e-3, atol=5e-5, err_msg=name)
        np.testing.assert_array_equal(
            got["live"][name],
            torch.as_tensor(got["master"][name]).bfloat16().float().numpy())
    for name, want in ref["stats"].items():
        np.testing.assert_allclose(got["live"][name], want.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_dp_sampling_shards(dp_run):
    """`parallel.dryrun` at JAX's tiny sizes: a DP diffusion step and a DP
    SyncBN VAE step move the weights, and each rank's DDIM + pruning
    decode from its own generator gives a finite shard with voxels,
    distinct from the other rank's and equal bit for bit to the sample a
    single process draws with that rank's generator."""
    _, ranks = dp_run
    rec = ranks[0]["dp_sampling"]
    dryrun.check(rec)
    assert len(rec["kept_per_rank"]) == 2
    assert rec["equal_single_process"] == [True, True]
    assert rec["shards_differ"] and rec["finite"]


def test_vq_process_group_matches_jax(dp_run):
    """The EMA quantizer's counts and sums summed over the ranks (JAX's
    ``psum`` over ``axis_name``): each rank's code indices exactly, and
    every buffer after two steps within 1e-5, the same on both ranks."""
    refs, ranks = dp_run
    ref = refs["vq_ema"]
    for r, res in enumerate(ranks):
        got = res["vq_ema"]
        for step, (i, want) in enumerate(zip(got["idx"], ref["idx"])):
            np.testing.assert_array_equal(i, want[r],
                                          err_msg=f"rank {r} step {step}")
        for name, want in ref["state"].items():
            np.testing.assert_allclose(got["state"][name], want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    assert ranks[0]["vq_ema"]["state"]["steps"] == 2
    for name, t in ranks[0]["vq_ema"]["state"].items():
        np.testing.assert_array_equal(t, ranks[1]["vq_ema"]["state"][name])
