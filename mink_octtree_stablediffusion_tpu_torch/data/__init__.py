"""Host-side data: synthetic and procedural shapes, batching and
collation."""

from .collate import (collate_fields, collate_pointclouds, device_row,
                      stack_devices)
from .datasets import (ProceduralShapes, SyntheticShapes, batch_iterator,
                       normalize_to_resolution)
