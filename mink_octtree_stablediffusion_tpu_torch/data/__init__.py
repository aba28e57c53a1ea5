"""Host-side data: synthetic shapes, batching and collation."""

from .collate import collate_pointclouds
from .datasets import SyntheticShapes, batch_iterator, normalize_to_resolution
