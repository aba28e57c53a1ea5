"""Sparse ops: coordinate engine, kernel maps, convolutions, reductions."""

from .conv import (default_compute_dtype, gather_rows, linear_apply,
                   set_default_compute_dtype, sparse_conv_apply)
from .coords import (INVALID_COORD, SparseGrid, batched_coordinates_np,
                     expand_grid, flat_cell_key, make_grid, pad_to_capacity,
                     sparse_quantize_np, stride_grid, unique_coords)
from .dense_conv import (dense_conv_apply, dense_conv_general_apply,
                         dense_no_growth_preferred, dense_no_growth_preferred2)
from .fused_conv import fused_sparse_conv
from .kernels import KernelSpec, RegionType, region_offsets
from .lut import LUT_MAX_ENTRIES, build_lut, lut_lookup
from .neighbors import grid_lookup, kernel_map, membership
from .pool import broadcast_batch, global_pool
from .pruning import prune, top_k_mask
from .reduce import reduce_by_inverse
from .search import lookup_sorted
# the dense entry is exported as vol_conv3d, as in the JAX package: the
# name vol_conv stays the submodule
from .vol_conv import brick_pallas_conv, enable_brick_conv
from .vol_conv import vol_conv as vol_conv3d
