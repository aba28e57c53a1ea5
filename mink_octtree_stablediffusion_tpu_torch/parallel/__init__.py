"""Data and tensor parallelism over ``torch.distributed``: process
groups and the ``(data, model)`` mesh, per-rank batches, SyncBN's
collective, the tensor-parallel layout (``shard_model_params``: each
model rank keeps its Cout slice of every conv and dense kernel).  The
data-parallel step is ``train.make_dp_train_step``; the entry points are
``python -m mink_octtree_stablediffusion_tpu_torch.multigpu_dp`` and
``parallel.dryrun.dryrun_multichip`` (imported on demand)."""

from .mesh import (BACKENDS, all_reduce_sum, batch_sharding, check_backend,
                   data_parallel_mesh, free_port, gather_to_host,
                   initialize_distributed, rank_device, replicate,
                   shard_batch, shard_batch_pytree)
from .tp import (dp_tp_mesh, gather_model_params, param_shardings,
                 param_spec, shard_model_params)

__all__ = ["batch_sharding", "data_parallel_mesh", "dp_tp_mesh",
           "param_shardings", "param_spec", "shard_model_params",
           "initialize_distributed", "replicate", "shard_batch_pytree"]
