"""scann_torch: the PyTorch/CUDA port of scann_tpu.

A second package beside ``scann_tpu`` (the JAX reference, held against it
by tests/test_torch_*.py).  This slice serves tree-SQ end to end: build
(k-means tree, leaf splitting, tile-major residual int8 leaves) and
batched search through a hand-written CUDA kernel for the pruned int8
scorer (csrc/pruned_sq.cu), plus the float32 brute force used for ground
truth.  Entry points run on CUDA unless the caller asks for the CPU::

    import scann_torch
    searcher = (scann_torch.builder(db, 10, "dot_product")
                .tree(num_leaves=2000, num_leaves_to_search=100,
                      training_sample_size=250_000)
                .score_brute_force(quantize="int8")
                .build())
    neighbors, distances = searcher.search_batched(queries)

The package imports torch and numpy only (never jax or scann_tpu).
"""

from scann_torch.builder import ScannBuilder, builder
from scann_torch.config import (BruteForceConfig, PartitioningConfig,
                                ScannConfig)
from scann_torch.factory import create_searcher

__version__ = "0.1.0"

__all__ = ["ScannBuilder", "builder", "ScannConfig", "PartitioningConfig",
           "BruteForceConfig", "create_searcher", "load_searcher"]


def load_searcher(artifacts_dir, device="cuda"):
    """Load an index written by either package's serialize()."""
    from scann_torch.utils import serialization
    return serialization.load_searcher(artifacts_dir, device)
