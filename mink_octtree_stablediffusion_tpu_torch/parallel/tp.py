"""The tensor-parallel placement rule of `parallel/tp.py`.

Port of `param_spec` from `mink_octtree_stablediffusion_tpu/parallel/tp.py`
as ``torch.distributed.tensor`` placements on a model axis: a ``(K, Cin,
Cout)`` conv kernel with K > 1 is sharded on Cout (``Shard(2)``), a 2-D
dense kernel in flax's ``(in, out)`` layout on ``out`` (``Shard(1)``; the
port's ``Dense`` keeps ``weight [out, in]``, so its weight is passed
transposed), anything else, or a dimension that does not split into parts
of at least ``min_dim``, is replicated.  Only the rule is ported: the port
does not train under tensor parallelism.
"""

from __future__ import annotations

from typing import Sequence

from torch.distributed.tensor import Replicate, Shard


def param_spec(shape: Sequence[int], n_model: int, min_dim: int = 2):
    """The placement of one parameter of ``shape`` on a model axis of
    ``n_model`` ranks."""
    shape = tuple(shape)
    if (len(shape) == 3 and shape[0] > 1 and shape[2] % n_model == 0 and
            shape[2] // n_model >= min_dim):
        return Shard(2)
    if (len(shape) == 2 and shape[1] % n_model == 0 and
            shape[1] // n_model >= min_dim):
        return Shard(1)
    return Replicate()
