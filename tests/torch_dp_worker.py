"""The ranks of `test_torch_parallel.py` and of the data-parallel card
tests in `test_torch_cuda.py`: spawned processes that import PyTorch and
the port, never JAX.

``run(rank, world, port, payload, out, device)`` joins a gloo group over
loopback ``tcp://`` (on the CPU, or with both ranks on one card), runs
every job of ``payload`` (built by the test, as numpy arrays: JAX's draws
and the port's weights) in order and saves this rank's results to
``<out>/rank<r>.pt``.
"""

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch import multigpu_dp
from mink_octtree_stablediffusion_tpu_torch.parallel import dryrun
from mink_octtree_stablediffusion_tpu_torch.train import vae as train_vae


_DEV = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.array(a), device=_DEV)


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def _state(module) -> dict:
    return {n: _np(t) for n, t in module.state_dict().items()}


def collectives(rank: int, world: int) -> dict:
    """all_reduce, broadcast, and the differentiable sum's backward."""
    x = torch.full((3,), float(rank + 1), device=_DEV)
    dist.all_reduce(x)
    y = torch.full((2,), float(10 + rank), device=_DEV)
    dist.broadcast(y, 0)
    z = torch.full((2,), float(rank + 1), requires_grad=True, device=_DEV)
    s = mp.parallel.all_reduce_sum(z * 2.0)
    (s * (rank + 1)).sum().backward()
    # each rank's row of a stacked per-device batch; the data groups
    stacked = mp.data.stack_devices(
        [(np.full((2, 4), d, np.int32), np.full((2, 1), 10.0 * d,
                                                 np.float32))
         for d in range(world)])
    row = mp.parallel.shard_batch(stacked, device=_DEV)
    sub = mp.parallel.data_parallel_mesh(1)  # every rank calls new_group
    return {"all_reduce": _np(x), "broadcast": _np(y), "sum": _np(s),
            "sum_grad": _np(z.grad), "shard": [_np(t) for t in row],
            "world_is_default": mp.parallel.data_parallel_mesh()
            is dist.group.WORLD,
            "sub_size": dist.get_world_size(sub) if rank == 0 else None,
            "jax_imported": "jax" in sys.modules}


def sync_bn(rank: int, job: dict) -> dict:
    """One SyncBN forward and backward on this rank's rows."""
    c = job["scale"].shape[0]
    bn = mp.nn.BatchNorm(c, process_group=dist.group.WORLD, device=_DEV)
    bn.load_state_dict({"weight": _t(job["scale"]), "bias": _t(job["bias"]),
                        "running_mean": torch.zeros(c),
                        "running_var": torch.ones(c)})
    bn.train()
    cpad, valid, feats = (_t(a) for a in job["tensors"][rank])
    st = mp.sparse_tensor(cpad, feats, capacity=cpad.shape[0],
                          valid=valid, batch_size=2,
                          extent=(job["extent"],) * 3)
    f = st.features.clone().requires_grad_()
    y = bn(st.with_features(f))
    (y.features * _t(job["gout"][rank])).sum().backward()
    return {"y": _np(y.features), "df": _np(f.grad),
            "dscale": _np(bn.weight.grad), "dbias": _np(bn.bias.grad),
            "mean": _np(bn.running_mean), "var": _np(bn.running_var)}


def vae_step(rank: int, job: dict) -> dict:
    """One DP step of the SyncBN VAE on this rank's batch and draws."""
    cfg = job["cfg"]
    vae = mp.models.VAE(channels=cfg["channels"],
                        encoder_capacities=cfg["enc"],
                        decoder_capacities=cfg["dec"], latent_canvas=True,
                        process_group=dist.group.WORLD, device=_DEV)
    vae.load_state_dict({n: _t(a) for n, a in job["state"].items()})
    state = mp.train.TrainState(vae, mp.train.vae_optimizer(
        vae.parameters(), 1e-3))
    step = mp.train.make_dp_train_step(train_vae.build_loss_fn(
        input_capacity=cfg["cap"], batch_size=cfg["b"],
        resolution=cfg["res"], kld_weight=1e-6, device=_DEV))
    b1 = mp.ops.fused_conv.fused_sparse_conv
    before = b1.launches
    loss, aux = step(state, job["batches"][rank], eps=_t(job["eps"][rank]),
                     canvas_noise=_t(job["canvas_noise"][rank]))
    return {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
            "state": _state(vae), "comm": dict(step.comm),
            "b1_launches": b1.launches - before}


def resnet_bf16_step(rank: int, job: dict) -> dict:
    """One DP step of a narrow SyncBN ResNet14 under bf16 storage."""
    cfg = job["cfg"]
    net = mp.models.ResNet14(out_channels=4, planes=cfg["planes"],
                             init_dim=cfg["init_dim"],
                             input_capacity=cfg["cap"],
                             process_group=dist.group.WORLD, device=_DEV)
    net.load_state_dict({n: _t(a) for n, a in job["state"].items()})
    state = mp.train.TrainState.create_mixed_precision(
        net, lambda ps: mp.train.vae_optimizer(ps, 1e-3))
    args = argparse.Namespace(capacity=cfg["cap"], batch_per_device=cfg["b"],
                              resolution=cfg["res"])
    step = mp.train.make_dp_train_step(
        multigpu_dp.build_loss_fn(args, _DEV))
    loss, _ = step(state, job["batches"][rank])
    names = [n for n, _ in net.named_parameters()]
    return {"loss": float(loss),
            "master": {n: _np(m)
                       for n, m in zip(names, state.optimizer.master)},
            "live_dtypes": sorted({str(p.dtype) for p in net.parameters()}),
            "live": _state(net)}


def dp_sampling(rank: int, job: dict) -> dict:
    """`parallel.dryrun`'s phases 1, 3 and 4 (rank 0's record)."""
    return dryrun.run_rank(2, _DEV)


def vq_ema(rank: int, job: dict) -> dict:
    """Two EMA train steps of ``VectorQuantizer(process_group=…)`` on this
    rank's latents (the counts and sums summed over the ranks)."""
    vq = mp.models.VectorQuantizer(job["k"], job["d"], ema=True,
                                   process_group=dist.group.WORLD,
                                   device=_DEV)
    vq.load_state_dict({n: _t(a) for n, a in job["stats"].items()})
    vq.train()
    idx = []
    for feats, valid in job["latents"]:
        n = feats[rank].shape[0]
        grid = mp.SparseGrid(coords=_t(np.zeros((n, 4), np.int32)),
                             valid=_t(valid[rank]), stride=(8, 8, 8),
                             batch_size=1)
        _, i, _ = vq(mp.SparseTensor(grid=grid, features=_t(feats[rank])))
        idx.append(i.cpu().numpy())
    return {"idx": idx, "state": _state(vq)}


JOBS = {"sync_bn": sync_bn, "vae_step": vae_step,
        "resnet_bf16_step": resnet_bf16_step, "dp_sampling": dp_sampling,
        "vq_ema": vq_ema}


def run(rank: int, world: int, port: int, payload: dict, out: str,
        device: str = "cpu") -> None:
    global _DEV
    _DEV = mp.parallel.rank_device(device, rank, 1)
    torch.set_num_threads(1)
    mp.parallel.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       backend="gloo")
    try:
        res = {"collectives": collectives(rank, world)}
        for name, job in payload.items():
            res[name] = JOBS[name](rank, job)
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
