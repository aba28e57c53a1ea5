"""Sparse network layers (``torch.nn.Module``s over SparseTensor)."""

from .act import get_act
from .attention import SparseAttention, SparseTransformer
from .blocks import BasicBlock, ResNetStack
from .conv import (GenerativeConvTranspose, Route, SparseConv,
                   SparseConvTranspose, record_routes)
from .embed import TimestepEmbedding, timesteps_embedding
from .init import init_parameters
from .linear import Dense
from .norm import BatchNorm, StableInstanceNorm
from .pool import broadcast_op
