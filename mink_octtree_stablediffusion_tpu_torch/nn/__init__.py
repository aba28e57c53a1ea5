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
from .embed import (LinearPositionalEncoding, TimestepEmbedding,
                    timesteps_embedding)
from .init import init_parameters
from .linear import Dense, Linear
from .norm import (AdaStableInstanceNorm, BatchNorm, DenseBatchNorm,
                   GroupNormDense, HjmInstanceNorm, InstanceNorm,
                   StableGroupNorm, StableInstanceNorm)
from .pool import (GlobalMaxAvgPool, GlobalPool, LocalPool, PoolTranspose,
                   broadcast_concat, broadcast_op, global_pool_features)
