"""scann_torch: the PyTorch/CUDA port of scann_tpu.

A second package beside ``scann_tpu`` (the JAX reference, held against it
by tests/test_torch_*.py).  It serves two engines end to end, each with
build, serialization and batched search through hand-written CUDA kernels:
tree-SQ (k-means tree, tile-major residual int8 leaves, the pruned int8
scorer csrc/pruned_sq.cu) and tree-AH (product codes with anisotropic
encoding, with or without a tree; the int8-LUT scorer csrc/pruned_lut.cu,
the decode scorer csrc/pruned_codes.cu, and in reconstruct mode the
decoded-row scorer csrc/pruned_rows.cu and the fused full scan
csrc/fused_scan.cu; then float32 / bfloat16 / residual-int8 reordering),
plus the float32 brute force used for ground truth.  Both engines can
merge through csrc/merge_groups.cu (SCANN_TORCH_FUSED_MERGE=1).  Entry
points run on CUDA unless the caller asks for the CPU::

    import scann_torch
    searcher = (scann_torch.builder(db, 10, "dot_product")
                .tree(num_leaves=2000, num_leaves_to_search=100,
                      training_sample_size=250_000)
                .score_brute_force(quantize="int8")
                .build())
    neighbors, distances = searcher.search_batched(queries)

    searcher = (scann_torch.builder(db, 10, "dot_product")
                .tree(num_leaves=2000, num_leaves_to_search=100,
                      training_sample_size=250_000)
                .score_ah(2, anisotropic_quantization_threshold=0.2)
                .reorder(100)
                .build())

The package imports torch and numpy only (never jax or scann_tpu).
"""

from scann_torch.builder import ScannBuilder, builder
from scann_torch.config import (AsymmetricHashConfig, BruteForceConfig,
                                PartitioningConfig, ReorderConfig,
                                ScannConfig)
from scann_torch.factory import create_searcher

__version__ = "0.1.0"

__all__ = ["ScannBuilder", "builder", "ScannConfig", "PartitioningConfig",
           "AsymmetricHashConfig", "BruteForceConfig", "ReorderConfig",
           "create_searcher", "load_searcher"]


def load_searcher(artifacts_dir, device="cuda"):
    """Load an index written by either package's serialize()."""
    from scann_torch.utils import serialization
    return serialization.load_searcher(artifacts_dir, device)
