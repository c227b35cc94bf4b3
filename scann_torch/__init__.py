"""scann_torch: the PyTorch/CUDA port of scann_tpu.

A second package beside ``scann_tpu`` (the JAX reference, held against it
by tests/test_torch_*.py).  It serves, each with build, serialization and
batched search:

* tree-SQ (k-means tree, tile-major residual int8 leaves, the pruned int8
  scorer csrc/pruned_sq.cu), with or without float32 / bfloat16 /
  residual-int8 / per-dimension int8 reordering;
* tree-AH (product codes with anisotropic encoding, with or without a
  tree; the int8-LUT scorer csrc/pruned_lut.cu, the decode scorer
  csrc/pruned_codes.cu, and in reconstruct mode the decoded-row scorer
  csrc/pruned_rows.cu and the fused full scan csrc/fused_scan.cu; then the
  same reorderings), at every width;
* every other score_brute_force composition, plain torch: brute force
  over float32, int8 or bfloat16 rows, Tree-X with float32, bfloat16 or
  global-int8 dense leaves and the single-leaf tree, each with or
  without reordering; dot product, squared L2 and cosine, and float32
  brute-force L1.

Both pruned engines can merge through csrc/merge_groups.cu
(SCANN_TORCH_FUSED_MERGE=1).  The search features run around the same
kernels: SOAR (tree-AH), AVQ, int8 centroids, query spilling, upper and
hierarchical trees, crowding, pre-tokenized leaves, reordering epsilons
and per-query k.  Entry points run on CUDA unless the caller
asks for the CPU::

    import scann_torch
    searcher = (scann_torch.builder(db, 10, "squared_l2")
                .tree(num_leaves=2000, num_leaves_to_search=100,
                      training_sample_size=100_000)
                .score_brute_force(quantize="int8")
                .reorder(40)
                .build())
    neighbors, distances = searcher.search_batched(queries,
                                                   leaves_to_search=8)

    searcher = (scann_torch.builder(db, 10, "dot_product")
                .tree(num_leaves=2000, num_leaves_to_search=100,
                      training_sample_size=250_000)
                .score_ah(2, anisotropic_quantization_threshold=0.2)
                .reorder(100)
                .build())

    searcher = (scann_torch.builder(db, 10, "cosine")
                .score_brute_force(quantize="bfloat16").build())

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
