"""Sparse ops: coordinate engine, kernel maps, convolutions, reductions."""

from .brick import brick_sparse_conv
from .canvas import canvas_grid, expand_to_canvas
from .conv import (default_compute_dtype, gather_rows, linear_apply,
                   set_default_compute_dtype, sparse_conv_apply)
from .coords import (INVALID_COORD, SparseGrid, batched_coordinates_np,
                     canonical_order, expand_grid, flat_cell_key, make_grid,
                     origin_grid, pad_to_capacity, sparse_quantize_np,
                     stride_grid, unique_coords)
from .dense_conv import (dense_conv_applicable, dense_conv_apply,
                         dense_conv_general_apply, dense_no_growth_preferred,
                         dense_no_growth_preferred2, enable_dense_conv,
                         enable_dense_no_growth)
from .fused_conv import fused_sparse_conv
from .hashtable import HashTable, build_table, lookup, pack_keys
from .interp import (interpolate, interpolation_weights, splat,
                     splat_coordinates)
from .kernels import (KernelSpec, RegionType, hybrid_region_offsets,
                      region_offsets)
from .lut import LUT_MAX_ENTRIES, build_lut, lut_lookup
from .morton import morton_decode, morton_encode, morton_encode_np
from .neighbors import (get_coords_map, grid_lookup, identity_map,
                        kernel_map, lookup_route, membership)
# as in the JAX package; the name onehot_conv stays the submodule
from .onehot_conv import onehot_sparse_conv, use_onehot_conv
from .pool import broadcast_batch, global_pool, local_pool_apply
from .pruning import prune, top_k_mask
from .reduce import reduce_by_inverse, slice_by_inverse
from .search import lookup_sorted
from .union import union
# the dense entry is exported as vol_conv3d, as in the JAX package: the
# name vol_conv stays the submodule
from .vol_conv import brick_pallas_conv, enable_brick_conv
from .vol_conv import vol_conv as vol_conv3d
# the kernels as operators (torch.ops.mink_torch): imported last, after
# the modules whose launchers and plain versions it registers
from . import library  # noqa: E402,F401
