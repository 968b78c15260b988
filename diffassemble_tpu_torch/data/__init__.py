"""Host-side input pipeline (numpy): patchify, expander topologies, batching."""

from .batch import PuzzleBatch, collate_puzzles  # noqa: F401
from .expander import expander_mask, parse_degree  # noqa: F401
from .patchify import ROT_VECTORS, grid_positions, make_puzzle, patchify, rotate_patches  # noqa: F401
