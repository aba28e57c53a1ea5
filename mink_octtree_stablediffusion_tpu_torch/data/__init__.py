"""Host-side data: synthetic shapes and collation."""

from .collate import collate_pointclouds
from .datasets import SyntheticShapes, normalize_to_resolution
