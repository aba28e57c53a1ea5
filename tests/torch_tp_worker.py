"""The ranks of `test_torch_tp.py`: four spawned processes, a 2 × 2
``(data, model)`` mesh in one gloo group over loopback ``tcp://``, that
import PyTorch and the port, never JAX.

``run(rank, world, port, payload, out)`` runs the jobs below on the
payload the test builds (numpy arrays: JAX's weights, latents and draws)
and saves this rank's results to ``<out>/rank<r>.pt``.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.parallel import dryrun, tp

_DEV = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.array(a), device=_DEV)


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def _unet(job, remat=False):
    unet = mp.models.UNet(**job["unet"], remat=remat, device=_DEV)
    unet.load_state_dict({n: _t(a) for n, a in job["state"].items()})
    return unet


def _latent(job, lat):
    coords, valid, feats = lat
    return mp.sparse_tensor(_t(coords), _t(feats), valid=_t(valid),
                            **job["latent"])


def _loss_fn(job):
    sched = mp.diffusion.DDPMScheduler.create(num_train_timesteps=100)

    def loss_fn(unet, batch):
        lat, t, noise = batch
        return mp.diffusion.diffusion_training_loss(
            unet, sched, _latent(job, lat), resolution=job["resolution"],
            timesteps=_t(t), noise=_t(noise))
    return loss_fn


def _step(job, unet, batch, group):
    """One SGD step of ``unet`` (sharded or not) averaged over ``group``
    (None: one process); → (loss, the loss after the step on the post
    draws)."""
    loss_fn = _loss_fn(job)
    state = mp.train.TrainState(unet, torch.optim.SGD(unet.parameters(),
                                                      job["lr"]))
    if group is None:
        loss, _ = mp.train.make_train_step(loss_fn)(state, batch)
    else:
        loss, _ = mp.train.make_dp_train_step(loss_fn, group)(state, batch)
    with torch.no_grad():
        post, _ = loss_fn(unet, (batch[0],) + tuple(job["post"]))
    return float(loss), float(post)


def jittered(batch):
    """``batch`` with the latent's features moved by float32 rounding (×
    (1 ± 1e-7), signs from a seeded draw): a step on it measures how far
    summation-order noise moves this model's loss and parameters."""
    (coords, valid, feats), t, noise = batch
    sign = np.random.RandomState(99).choice([-1.0, 1.0], feats.shape)
    return ((coords, valid, (feats * (1.0 + 1e-7 * sign)).astype(
        np.float32)), t, noise)


def _tp_step(job, mesh, batch, remat=False) -> dict:
    unet = mp.parallel.shard_model_params(_unet(job, remat), mesh)
    tp.reset_comm()
    loss, post = _step(job, unet, batch, mesh.get_group("data"))
    return {"loss": loss, "post": post,
            "gathered": {n: _np(t) for n, t in
                         mp.parallel.gather_model_params(unet, mesh).items()},
            "local": {n: _np(p) for n, p in unet.named_parameters()},
            "sharded": sorted(n for n, p in unet.named_parameters()
                              if hasattr(p, "model_shard")),
            "comm": {k: dict(v) for k, v in tp.COMM.items()}}


def adafactor(mesh) -> dict:
    """Two Adafactor steps (clipping on) of two dense layers whose
    weights factor (both dimensions ≥ 128), one sharded on its factored
    row axis and one on its column axis, sharded and in one process."""
    def build():
        g = torch.Generator().manual_seed(5)
        net = torch.nn.ModuleDict({"a": mp.nn.Dense(128, 256),
                                   "b": mp.nn.Dense(256, 128)})
        for m in net.values():
            m.reset_parameters(generator=g)
            with torch.no_grad():
                m.bias.normal_(generator=g)
        return net
    x = torch.randn(16, 128, generator=torch.Generator().manual_seed(6))

    def loss_fn(net, batch):
        return (net["b"](torch.tanh(net["a"](batch))) ** 2).mean(), {}

    out = {}
    for key, net in (("single", build()),
                     ("tp", mp.parallel.shard_model_params(build(), mesh))):
        state = mp.train.TrainState(net, mp.train.optim.AdafactorOptimizer(
            net.parameters(), lambda t: 1e-2, clip_norm=0.5))
        step = (mp.train.make_train_step(loss_fn) if key == "single" else
                mp.train.make_dp_train_step(loss_fn,
                                            mesh.get_group("data")))
        for _ in range(2):
            step(state, x)
        out[key] = {n: _np(t) for n, t in
                    (mp.parallel.gather_model_params(net, mesh).items()
                     if key == "tp" else net.named_parameters())}
    return out


def run(rank: int, world: int, port: int, payload: dict, out: str) -> None:
    torch.set_num_threads(1)
    mp.parallel.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       backend="gloo")
    try:
        mesh = mp.parallel.dp_tp_mesh(2, world // 2, "cpu")
        row = mesh.get_local_rank("data")
        job = payload["job"]
        same = (job["same"], *job["draws"])
        res = {"groups": [dist.get_process_group_ranks(mesh.get_group(a))
                          for a in ("data", "model")],
               "placements": {n: (repr(d), repr(m)) for n, (d, m) in
                              mp.parallel.param_shardings(
                                  _unet(job), mesh).items()},
               "batch_placements": [repr(p) for p in
                                    mp.parallel.batch_sharding(mesh)],
               "replicate": [repr(p) for p in mp.parallel.replicate(mesh)],
               "batch_row": [_np(t) for t in mp.parallel.shard_batch_pytree(
                   payload["stacked"], mesh)["x"]],
               "same": _tp_step(job, mesh, same),
               "remat": _tp_step(job, mesh, same, remat=True)}
        # distinct batches a data row: dp x tp, and dp alone over the row's
        # data group
        mine = (job["distinct"][row], *job["distinct_draws"][row])
        res["distinct"] = _tp_step(job, mesh, mine)
        for key, batch in (("distinct_dp", mine),
                           ("distinct_dp_jittered", jittered(mine))):
            unet = _unet(job)
            loss, _ = _step(job, unet, batch, mesh.get_group("data"))
            res[key] = {"loss": loss, "params": {
                n: _np(p) for n, p in unet.named_parameters()}}
        if rank == 0:  # one process, no collective
            for key, batch in (("single", same),
                               ("single_jittered", jittered(same))):
                loss, post = _step(job, _unet(job), batch, None)
                res[key] = {"loss": loss, "post": post}
        res["tp_phase"] = dryrun.tp_phase(mesh, _DEV)
        res["adafactor"] = adafactor(mesh)
        res["jax_imported"] = "jax" in sys.modules
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
