"""Sparse network layers (``torch.nn.Module``s over SparseTensor)."""

from .act import (AdaptiveLogSoftmaxWithLoss, AlphaDropout, Dropout, PReLU,
                  RReLU, Sinusoidal, apply_fn, elu, gelu, get_act, hardshrink,
                  relu, sigmoid, silu, softmax, softshrink, tanh, threshold)
from .attention import (AttentionRoute, MortonWindowTransformer,
                        SparseAttention, SparseTransformer, record_attention)
from .blocks import (BasicBlock, ResBasicBlock, ResBottleneck, ResNetStack,
                     SEBasicBlock, SEBottleneck, SELayer)
from .conv import (ChannelwiseConv, GenerativeConvTranspose, Route,
                   SparseConv, SparseConvTranspose, UpsampleInterpolate,
                   record_routes)
from .embed import TimestepEmbedding, timesteps_embedding
from .init import init_parameters
from .linear import Dense
from .norm import BatchNorm, DenseBatchNorm, StableInstanceNorm
from .pool import (GlobalMaxAvgPool, GlobalPool, LocalPool, PoolTranspose,
                   broadcast_concat, broadcast_op, global_pool_features)
