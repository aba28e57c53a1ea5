"""Tensor parallelism of the port (`parallel/tp.py`, the column-parallel
convs and ``Dense``) against the JAX package, on the CPU.

One spawn of four port ranks (`torch_tp_worker.py`, which imports no
JAX) forms a 2 × 2 ``(data, model)`` mesh in a gloo group over loopback
``tcp://``; while they run, this process takes JAX's steps.  The model
is `tests/test_parallel_tp.py`'s: UNet ``(4, 8, 16, 16)``,
``attn_max_len`` 32, down capacities (32, 16, 8), group 4, on a
stride-8 latent of 64 rows, DDPM with 100 steps, no NLL, SGD at 1e-2.
Both packages start from JAX's init (``jax.jit(unet.init)``, carried in
through ``utils.convert``), and the port takes JAX's timesteps and noise
as arrays.  Float32 throughout (the CPU's compute dtype,
`ops/conv.py:39-45`).

- (i) every parameter's placement from ``param_shardings`` maps,
  through ``utils.convert``'s name map, onto JAX's ``param_shardings``
  for the same leaf: 104 conv kernels ``Shard(2)``, 108 dense kernels on
  ``out`` (the port's ``weight [out, in]``: ``Shard(0)``), 264
  replicated.
- (ii) the dp × tp step, both data rows on the same batch, against
  JAX's single-device ``jax.jit(step)``, within `test_parallel_tp.py`'s
  own bounds: the loss within rtol 1e-4; the post-step loss within
  max(10 × the measured float32 sensitivity, 1e-4 relative) of JAX's;
  the gathered parameters within rtol 2e-2 / atol 2e-3.
- (iii) the same step against the port's own single-process step: the
  loss within max(10 × its float32 sensitivity, 1e-6 relative).
- (iv) distinct batches a data row against the port's data-parallel
  step without tensor parallelism (``make_dp_train_step`` over the
  row's data group): float32 reassociation only, measured as (ii) does:
  the loss within max(10 × its sensitivity, 1e-6 relative), each
  parameter's ‖Δ‖ within 10 × the ‖Δ‖ that a step on features jittered
  by 1e-7 relative gives, + 1e-6·‖p‖.

(iii) and (iv) take the sensitivity as `test_parallel_tp.py` does:
these levels hold one to three voxels an instance, whose instance norms
amplify float32 rounding, so no fixed bound near 1e-6 separates a wrong
step from reassociation (a 1e-7 jitter moves one row's loss by 2e-5 of
itself and a conv kernel's gradient by 12 in 506).
- (v) after the step the two model ranks' replicated parameters are
  equal bit for bit, so are the two data ranks' slices, and every slice
  keeps its local shape.
- (vi) ``remat`` gives the same loss and the same parameters.
- (vii) ``parallel.dryrun.tp_phase`` passes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import diffusion as md
from mink_octtree_stablediffusion_tpu import models as mm
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.utils import convert
from mink_octtree_stablediffusion_tpu_torch.utils.convert import from_flax

import torch_tp_worker

torch.set_num_threads(1)

B, CAP, STRIDE, RES, T = 2, 64, 8, 4, 100
UNET = dict(channels=(4, 8, 16, 16), attn_max_len=32,
            down_capacities=(32, 16, 8), group=4)
LATENT = dict(capacity=CAP, batch_size=B, stride=STRIDE,
              extent=(RES * STRIDE,) * 3)
LR = 1e-2


def _within_sensitivity(got, ref, jittered):
    """|got − ref| ≤ max(10·|jittered − ref|, 1e-6·|ref|)."""
    gap, sens = abs(got - ref), abs(jittered - ref)
    assert gap <= max(10.0 * sens, 1e-6 * abs(ref)), (got, ref, sens)


def _latent(rng, n=20):
    vox = [np.unique(rng.randint(0, RES, (n, 3)), axis=0) * STRIDE
           for _ in range(B)]
    cpad, vpad = mt.ops.pad_to_capacity(mt.ops.batched_coordinates_np(vox),
                                        CAP)
    feats = (rng.randn(CAP, 4) * vpad[:, None]).astype(np.float32)
    return cpad, vpad, feats


def _port_names(variables, module):
    """flax params path → the port's parameter name (`utils.convert`)."""
    ref = module.state_dict()
    port_modules = frozenset(n.rsplit(".", 1)[0] for n in ref)
    out = {}
    for path, value in convert._leaves(variables["params"]):
        name, _ = convert._translate("params", path, np.zeros(value.shape),
                                     port_modules=port_modules)
        out[path] = name
    return out


def _jax_case():
    """JAX's UNet, init and latent (`test_parallel_tp.py`'s setup), the
    worker's payload, and the jitted step."""
    cpad, vpad, feats = _latent(np.random.RandomState(0))
    st = jax.jit(lambda c, f, v: mt.sparse_tensor(
        c, f, capacity=CAP, batch_size=B, stride=STRIDE, valid=v,
        extent=(RES * STRIDE,) * 3))(jnp.asarray(cpad), jnp.asarray(feats),
                                     jnp.asarray(vpad))
    unet = mm.UNet(**UNET)
    variables = jax.jit(unet.init)(jax.random.PRNGKey(0), st,
                                   jnp.zeros((B,), jnp.int32))
    sched = md.DDPMScheduler.create(num_train_timesteps=T)
    tx = optax.sgd(LR)

    def loss_fn(v, st, key):
        def unet_apply(noised, timesteps, ehs):
            return unet.apply(v, noised, timesteps, ehs)
        loss, _ = md.diffusion_training_loss(unet_apply, sched, st, key,
                                             resolution=RES * STRIDE)
        return loss

    def step(v, opt_state, st, key):
        loss, grads = jax.value_and_grad(loss_fn)(v, st, key)
        updates, opt_state = tx.update(grads, opt_state, v)
        return optax.apply_updates(v, updates), opt_state, loss

    @jax.jit
    def draws(key):  # `diffusion_training_loss`'s timesteps and noise
        r_t, r_n = jax.random.split(key)
        return (jax.random.randint(r_t, (B,), 0, T),
                jax.random.normal(r_n, st.features.shape, st.features.dtype))

    pu = mp.models.UNet(**UNET, device="cpu")
    state = {n: t.numpy() for n, t in from_flax(variables, pu).items()}
    rng = np.random.RandomState(3)
    distinct = [_latent(np.random.RandomState(r)) for r in (1, 2)]
    # the port sorts its rows as JAX does: the draws follow JAX's order
    lat = tuple(np.asarray(a) for a in (st.grid.coords, st.grid.valid,
                                        st.features))
    job = {"unet": UNET, "latent": LATENT, "resolution": RES * STRIDE,
           "lr": LR, "state": state, "same": lat,
           "draws": [np.asarray(a) for a in draws(jax.random.PRNGKey(7))],
           "post": [np.asarray(a) for a in draws(jax.random.PRNGKey(11))],
           "distinct": distinct,
           "distinct_draws": [(rng.randint(0, T, B).astype(np.int32),
                               rng.randn(CAP, 4).astype(np.float32))
                              for _ in distinct]}
    stacked = {"x": (np.arange(6).reshape(2, 3),
                     np.arange(8.0, dtype=np.float32).reshape(2, 4))}
    return {"job": job, "stacked": stacked}, (unet, variables, st, step, pu)


def _jax_steps(unet, variables, st, step):
    """`test_parallel_tp.py`'s single-device reference: the step, the
    post-step loss (key 11) and its float32 sensitivity (the step redone
    on features jittered by 1e-7 relative)."""
    fn = jax.jit(step)
    tx = optax.sgd(LR)
    key = jax.random.PRNGKey(7)
    v1, _, l1 = fn(variables, tx.init(variables), st, key)
    l1b = fn(v1, tx.init(v1), st, jax.random.PRNGKey(11))[2]
    st_j = st.with_features(st.features * (1.0 + 1e-7 * jax.random.rademacher(
        jax.random.PRNGKey(99), st.features.shape).astype(
            st.features.dtype)))
    v1j = fn(variables, tx.init(variables), st_j, key)[0]
    l1j = fn(v1j, tx.init(v1j), st, jax.random.PRNGKey(11))[2]
    return {"loss": float(l1), "post": float(l1b),
            "sensitivity": abs(float(l1j) - float(l1b)),
            "params": {n: t.numpy() for n, t in
                       from_flax({"params": v1["params"]}).items()}}


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The four ranks, spawned first; JAX's steps while they run; →
    (JAX's reference, per-rank results, flax variables, port UNet)."""
    payload, (unet, variables, st, step, pu) = _jax_case()
    out = str(tmp_path_factory.mktemp("tp"))
    ctx = torch.multiprocessing.start_processes(
        torch_tp_worker.run, args=(4, mp.parallel.free_port(), payload, out),
        nprocs=4, join=False, start_method="spawn")
    try:
        ref = _jax_steps(unet, variables, st, step)
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    return ref, ranks, variables, pu


def test_mesh_groups_and_batch_placements(tp_run):
    """Adjacent ranks on the model axis; the batch helpers."""
    _, ranks, _, _ = tp_run
    for r, res in enumerate(ranks):
        first = r - r % 2  # the first rank of this rank's model group
        assert res["groups"] == [[r % 2, r % 2 + 2], [first, first + 1]]
        assert res["batch_placements"] == ["Shard(dim=0)", "Replicate()"]
        assert res["replicate"] == ["Replicate()"] * 2
        row = r // 2  # this rank's data row
        np.testing.assert_array_equal(res["batch_row"][0],
                                      np.arange(6).reshape(2, 3)[row])
        np.testing.assert_array_equal(res["batch_row"][1],
                                      np.arange(8.0).reshape(2, 4)[row])
        assert not res["jax_imported"]  # the ranks never import JAX


def test_placements_match_jax_leaf_for_leaf(tp_run):
    """(i) each port parameter's model placement is JAX's for its leaf."""
    _, ranks, variables, pu = tp_run
    got = ranks[0]["placements"]
    shardings = mt.parallel.param_shardings(
        variables, mt.parallel.dp_tp_mesh(2, 2, devices=jax.devices()[:4]))
    names = _port_names(variables, pu)
    want = {P(None, None, "model"): "Shard(dim=2)",
            P(None, "model"): "Shard(dim=0)", P(): "Replicate()"}
    counts = {}
    for path, sh in convert._leaves(shardings["params"]):
        assert isinstance(sh, NamedSharding)
        data, model = got[names[path]]
        assert data == "Replicate()"
        assert model == want[sh.spec], (path, names[path], sh.spec, model)
        counts[model] = counts.get(model, 0) + 1
    assert len(got) == len(names) == 476
    assert counts == {"Shard(dim=2)": 104, "Shard(dim=0)": 108,
                      "Replicate()": 264}


def test_dp_tp_step_matches_jax_single_device(tp_run):
    """(ii) within `test_parallel_tp.py`'s bounds."""
    ref, ranks, _, _ = tp_run
    for res in ranks:
        got = res["same"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
        gap = abs(got["post"] - ref["post"])
        assert gap <= max(10.0 * ref["sensitivity"], 1e-4 * abs(ref["post"])
                          ), (gap, ref["sensitivity"])
        np.testing.assert_allclose(got["post"], ref["post"], rtol=1e-2)
        assert set(got["gathered"]) == set(ref["params"])
        for name, want in ref["params"].items():
            np.testing.assert_allclose(got["gathered"][name], want,
                                       rtol=2e-2, atol=2e-3, err_msg=name)


def test_dp_tp_step_matches_single_process(tp_run):
    """(iii) the port's own single-process step on the same batch."""
    _, ranks, _, _ = tp_run
    single, jittered = ranks[0]["single"], ranks[0]["single_jittered"]
    for res in ranks:
        _within_sensitivity(res["same"]["loss"], single["loss"],
                            jittered["loss"])


def test_distinct_batches_match_data_parallel_step(tp_run):
    """(iv) a batch of its own a data row: dp x tp against dp alone."""
    _, ranks, _, _ = tp_run
    for res in ranks:
        tp_, dp = res["distinct"], res["distinct_dp"]
        jit = res["distinct_dp_jittered"]
        _within_sensitivity(tp_["loss"], dp["loss"], jit["loss"])
        assert set(tp_["gathered"]) == set(dp["params"])
        for name, want in dp["params"].items():
            gap = np.linalg.norm(tp_["gathered"][name] - want)
            sens = np.linalg.norm(jit["params"][name] - want)
            assert gap <= 10.0 * sens + 1e-6 * np.linalg.norm(want), (
                name, gap, sens)
    # every rank reports the mean over both data rows
    assert ranks[0]["distinct"]["loss"] == ranks[3]["distinct"]["loss"]


@pytest.mark.parametrize("job", ["same", "distinct"])
def test_replicas_bit_for_bit_and_local_shapes(tp_run, job):
    """(v) the model ranks' replicated parameters and the data ranks'
    slices are equal bit for bit; each slice keeps its Cout/2 shape."""
    _, ranks, _, _ = tp_run
    a = ranks[0][job]
    assert len(a["sharded"]) == 104 + 108
    for r in range(1, 4):
        b = ranks[r][job]
        assert b["sharded"] == a["sharded"]
        for name, t in a["local"].items():
            if name in a["sharded"] and r % 2:  # the other model rank
                assert t.shape == b["local"][name].shape
            else:
                np.testing.assert_array_equal(t, b["local"][name],
                                              err_msg=f"rank {r} {name}")
        for name, t in a["gathered"].items():
            np.testing.assert_array_equal(t, b["gathered"][name])
    for name in a["sharded"]:
        full, local = a["gathered"][name], a["local"][name]
        dim = 2 if local.ndim == 3 else 0
        assert local.shape[dim] * 2 == full.shape[dim], name
        np.testing.assert_array_equal(
            np.take(full, range(local.shape[dim]), axis=dim), local)


def test_model_axis_collectives_counted(tp_run):
    """The activation gathers and the dF sums are counted; gloo moved
    bytes for each."""
    _, ranks, _, _ = tp_run
    comm = ranks[0]["same"]["comm"]
    # one gather a sharded layer call: every conv kernel and dense weight
    assert comm["gather"]["calls"] >= 104 + 108
    assert comm["dF_sum"]["calls"] > 0 and comm["dF_sum"]["bytes"] > 0
    assert comm["optim_sum"]["calls"] == 0  # SGD clips nothing


def test_remat_gives_the_same_step(tp_run):
    """(vi) the recompute's gathers run again inside the backward, in the
    same order on every model rank."""
    _, ranks, _, _ = tp_run
    for res in ranks:
        assert res["remat"]["loss"] == res["same"]["loss"]
        assert res["remat"]["post"] == res["same"]["post"]
        for name, t in res["same"]["gathered"].items():
            np.testing.assert_array_equal(res["remat"]["gathered"][name], t,
                                          err_msg=name)
    assert ranks[0]["remat"]["comm"]["gather"]["calls"] > \
        ranks[0]["same"]["comm"]["gather"]["calls"]


def test_dryrun_tp_phase(tp_run):
    """(vii) JAX's phase 2: finite, the conv kernels keep their slices."""
    _, ranks, _, _ = tp_run
    for res in ranks:
        rec = res["tp_phase"]
        assert np.isfinite(rec["tp_loss"])
        assert rec["tp_kept"] == rec["tp_sharded"] == 104


def test_adafactor_factors_the_whole_parameter(tp_run):
    """Adafactor's factored second moment of a sharded weight is the
    whole weight's (its row and column means summed over the model
    group): two steps, sharded against one process, to float32
    reassociation."""
    _, ranks, _, _ = tp_run
    for res in ranks:
        got = res["adafactor"]
        assert set(got["tp"]) == set(got["single"])
        for name, want in got["single"].items():
            np.testing.assert_allclose(got["tp"][name], want, rtol=1e-5,
                                       atol=1e-7, err_msg=name)


def test_shard_model_params_takes_any_module():
    """JAX's rule applies to any variables tree: a module outside the
    UNet (``ChannelwiseConv``'s ``[K, C]`` kernel, ``Sinusoidal``'s 2-D
    kernels, the NLL's Σ) shards without raising, gathers its whole
    weights at use, and a 1-rank model axis leaves the output as it was."""
    import torch.distributed as dist
    port = mp.parallel.free_port()
    mp.parallel.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                       backend="gloo")
    try:
        mesh = mp.parallel.dp_tp_mesh(1, 1, "cpu")
        g = torch.Generator().manual_seed(0)
        net = torch.nn.ModuleDict({
            "cw": mp.nn.ChannelwiseConv(4), "sin": mp.nn.Sinusoidal(4, 6),
            "nll": mp.diffusion.CoordNLLParams()})
        rows = mp.ops.pad_to_capacity(np.array(
            [[0, 0, 0, 0], [0, 1, 0, 0], [0, 1, 1, 0]], np.int32), 8)
        st = mp.sparse_tensor(torch.as_tensor(rows[0]), torch.randn(
            8, 4, generator=g), capacity=8, batch_size=1,
            valid=torch.as_tensor(rows[1]), extent=(4,) * 3)
        before = net["sin"](net["cw"](st)).features
        shardings = mp.parallel.param_shardings(net, mesh)
        mp.parallel.shard_model_params(net, mesh, min_dim=1)
        after = net["sin"](net["cw"](st)).features
        after.sum().backward()
        names = set(mp.parallel.gather_model_params(net, mesh))
    finally:
        dist.destroy_process_group()
    assert repr(shardings["cw.kernel"][1]) == "Shard(dim=1)"
    assert repr(shardings["nll.sigma"][1]) == "Shard(dim=1)"
    assert names == set(shardings)
    torch.testing.assert_close(after, before, rtol=0, atol=0)
    assert "cw.parametrizations.kernel.original" in dict(
        net.named_parameters())
