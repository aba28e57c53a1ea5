"""Host-side data (mesh files, synthetic and procedural shapes, batching
and collation), on-device procedural shapes and the prefetching
loader."""

from .collate import (collate_fields, collate_pointclouds, device_row,
                      stack_devices)
from .datasets import (ModelNet40Dataset, ObjaverseDataset, ProceduralShapes,
                       ShapeNetDataset, SyntheticShapes, batch_iterator,
                       load_obj, load_off)
from .device_shapes import pack_voxels, procedural_batch, sample_shape
from .mesh_files import write_glb, write_modelnet_tree, write_obj, write_off
from .mesh import (load_glb, normalize_to_resolution, point_budget,
                   resample_mesh, resample_mesh_count, rotate_point_cloud)
from .prefetch import PrefetchLoader
