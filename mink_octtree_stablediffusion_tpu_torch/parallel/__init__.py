"""Data parallelism over ``torch.distributed``: process groups, per-rank
batches, SyncBN's collective, the tensor-parallel placement rule.  The
data-parallel step is ``train.make_dp_train_step``; the entry points are
``python -m mink_octtree_stablediffusion_tpu_torch.multigpu_dp`` and
``parallel.dryrun.dryrun_multichip`` (imported on demand)."""

from .mesh import (BACKENDS, all_reduce_sum, check_backend,
                   data_parallel_mesh, free_port, gather_to_host,
                   initialize_distributed, rank_device, shard_batch)
from .tp import param_spec
