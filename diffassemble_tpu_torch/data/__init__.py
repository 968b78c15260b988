"""Host-side input pipeline (numpy): patchify, expander topologies, batching,
the 3D fractured-object datasets and (``text.py``, imported by no model) the
sentence-ordering datasets."""

from .batch import FragmentBatch, PuzzleBatch, collate_puzzles  # noqa: F401
from .breaking_bad import SyntheticFractures, collate_fragments, get_dataset_3d  # noqa: F401
from .expander import expander_mask, parse_degree  # noqa: F401
from .patchify import ROT_VECTORS, grid_positions, make_puzzle, patchify, rotate_patches, unpatchify  # noqa: F401
