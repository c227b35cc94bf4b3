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
and per-query k.  So do the data and encodings: typed int8 / uint8
datasets (1 B a dimension where the engine allows), pca / opq /
truncate / random-orthogonal projections, stacked and VARIABLE_CHUNK
codes, the single-leaf AH tree, and sparse input through hashed
projections (``sparse_searcher``) or an exact sparse scan
(``SparseExactSearcher``).  Built with docids (``build(docids=...)`` or a
``DenseDataset``'s), a brute-force or tree-AH searcher returns docids and
takes ``upsert``, ``delete`` and ``rebalance``, with the partitioning's
incremental threshold (a full rebalance, or split / merge maintenance)
and ``get_health_stats``.  Around the searchers: reference ScannConfig
text protos (``builder_from_pbtxt``, ``searcher_from_pbtxt``), autopilot
(``builder(...).autopilot()``), the reference library's index
directories (``load_reference_assets``, ``save_reference_assets``), an
HTTP server (``serve``, scann_torch.serving), ``torch.export`` programs
that search with no searcher (``save_exported_searcher``,
``load_exported_searcher``; the kernels are ``torch.library`` custom ops,
ops/library.py), and a ``torch.profiler`` trace
(scann_torch.utils.profiling).  Entry points run on CUDA unless the
caller asks for the CPU::

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

from scann_torch.builder import ReorderType, ScannBuilder, builder
from scann_torch.config import (AsymmetricHashConfig, BruteForceConfig,
                                PartitioningConfig, ProjectionConfig,
                                ReorderConfig, ScannConfig, SoarConfig)
from scann_torch.data.dataset import DenseDataset, MetadataGetter
from scann_torch.data.sparse import (SparseExactSearcher, SparseMatrix,
                                     sparse_searcher)
from scann_torch.factory import create_searcher

__version__ = "0.1.0"

__all__ = ["ScannBuilder", "ReorderType", "builder", "ScannConfig",
           "PartitioningConfig",
           "AsymmetricHashConfig", "BruteForceConfig", "ReorderConfig",
           "SoarConfig", "ProjectionConfig", "DenseDataset",
           "MetadataGetter", "SparseMatrix", "SparseExactSearcher",
           "sparse_searcher", "create_searcher", "load_searcher",
           "searcher_to_tensors", "searcher_from_tensors",
           "save_exported_searcher", "load_exported_searcher",
           "load_reference_assets", "save_reference_assets",
           "builder_from_pbtxt", "searcher_from_pbtxt", "serve"]


def load_searcher(artifacts_dir, device="cuda"):
    """Load an index written by either package's serialize()."""
    from scann_torch.utils import serialization
    return serialization.load_searcher(artifacts_dir, device)


def searcher_to_tensors(searcher):
    """Searcher -> flat dict of numpy arrays (checkpoint-embeddable); the
    JAX package reads it with its searcher_from_tensors."""
    from scann_torch.utils import serialization
    return serialization.searcher_to_tensors(searcher)


def searcher_from_tensors(tensors, device="cuda"):
    """Inverse of searcher_to_tensors (either package's dict)."""
    from scann_torch.utils import serialization
    return serialization.searcher_from_tensors(tensors, device)


def save_exported_searcher(path, searcher, **kwargs):
    """Export the searcher's search at one operating point as
    torch.export programs, one per query bucket (scann_torch/export.py)."""
    from scann_torch import export as _export
    return _export.save_exported_searcher(path, searcher, **kwargs)


def load_exported_searcher(path):
    """Reload a save_exported_searcher directory and search it without a
    searcher object, on the device it was exported on."""
    from scann_torch import export as _export
    return _export.load_exported_searcher(path)


def load_reference_assets(artifacts_dir, device="cuda"):
    """Load a reference-format (scann_assets.pbtxt) index directory into a
    live searcher on ``device``."""
    from scann_torch.utils import ref_assets
    return ref_assets.load_reference_assets(artifacts_dir, device)


def save_reference_assets(searcher, artifacts_dir,
                          lossy_reorder_downgrade=False):
    """Write a brute-force or tree-AH searcher as a reference-format index
    directory.  lossy_reorder_downgrade: re-quantize residual-int8 reorder
    rows to the reference's absolute int8 rows instead of raising."""
    from scann_torch.utils import ref_assets
    return ref_assets.save_reference_assets(
        searcher, artifacts_dir,
        lossy_reorder_downgrade=lossy_reorder_downgrade)


def builder_from_pbtxt(db, config_text, device="cuda"):
    """A builder on ``device`` configured from a reference ScannConfig
    text proto; call .build() on it."""
    from scann_torch.utils import config_text as _ct
    return _ct.builder_from_pbtxt(db, config_text, device)


def searcher_from_pbtxt(db, config_text, device="cuda"):
    """Build a searcher on ``device`` from a reference ScannConfig text
    proto."""
    from scann_torch.utils import config_text as _ct
    return _ct.searcher_from_pbtxt(db, config_text, device)


def serve(artifacts_dir, host="0.0.0.0", port=8080, block=True,
          device="cuda"):
    """Serve a serialized index on ``device`` over HTTP
    (scann_torch.serving)."""
    from scann_torch import serving
    return serving.serve(artifacts_dir, host=host, port=port, block=block,
                         device=device)
