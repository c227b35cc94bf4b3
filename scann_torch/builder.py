"""Fluent builder (port of the tree, upper_tree, score_ah,
score_brute_force and reorder surface of scann_tpu/builder.py).  The
methods for parts not ported yet raise NotImplementedError naming their
ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from scann_torch import config as cfg
from scann_torch.models import base


def _quantize_name(quantize) -> str:
    """Accept bool (legacy) or one of the config's quantize strings."""
    if quantize is True:
        return cfg.INT8
    if quantize is False:
        return cfg.FLOAT32
    if quantize in (cfg.FLOAT32, cfg.INT8, cfg.BFLOAT16):
        return quantize
    raise ValueError(f"unsupported quantization: {quantize!r}")


class ScannBuilder:
    """Builder; ``device`` is where the index is built and searched."""

    def __init__(self, db, num_neighbors: int, distance_measure: str,
                 device="cuda"):
        self.device = base.resolve_device(device)
        self.db = np.asarray(db, dtype=np.float32)
        self.num_neighbors = num_neighbors
        self.distance_measure = distance_measure
        self._partitioning: Optional[cfg.PartitioningConfig] = None
        self._bf: Optional[cfg.BruteForceConfig] = None
        self._ah: Optional[cfg.AsymmetricHashConfig] = None
        self._reorder: Optional[cfg.ReorderConfig] = None
        self._upper_tree: Optional[cfg.UpperTreeConfig] = None
        self.seed = 42

    def set_seed(self, seed: int) -> "ScannBuilder":
        self.seed = seed
        return self

    def tree(self, num_leaves, num_leaves_to_search,
             training_sample_size=100000, min_partition_size=50,
             training_iterations=12, spherical=False, quantize_centroids=False,
             random_init=True, incremental_threshold=None,
             incremental_mode="online", avq=None,
             soar_lambda=None, overretrieve_factor=None,
             query_spilling_type="fixed_number",
             query_spilling_threshold=None,
             expected_spill_factor=2.0,
             hierarchical_top=0) -> "ScannBuilder":
        """Configure partitioning (same arguments as the JAX package; the
        factory raises for the settings not ported yet)."""
        if self._partitioning is not None:
            raise ValueError("tree has already been configured")
        if (avq is not None and cfg.internal_measure(self.distance_measure)
                != cfg.DOT_PRODUCT):
            raise ValueError("AVQ only applies to dot product distance.")
        soar = None
        if soar_lambda is not None:
            if (cfg.internal_measure(self.distance_measure)
                    != cfg.DOT_PRODUCT):
                raise ValueError("SOAR requires dot product distance.")
            soar = cfg.SoarConfig(
                lambda_=soar_lambda,
                overretrieve_factor=(overretrieve_factor
                                     if overretrieve_factor is not None
                                     else 2.0))
        self._partitioning = cfg.PartitioningConfig(
            num_leaves=num_leaves,
            num_leaves_to_search=num_leaves_to_search,
            training_sample_size=training_sample_size,
            min_partition_size=min_partition_size,
            training_iterations=training_iterations,
            spherical=spherical,
            quantize_centroids=quantize_centroids,
            random_init=random_init,
            incremental_threshold=incremental_threshold,
            incremental_mode=incremental_mode,
            query_spilling_type=query_spilling_type,
            query_spilling_threshold=query_spilling_threshold,
            expected_spill_factor=expected_spill_factor,
            hierarchical_top=hierarchical_top,
            avq=avq,
            soar=soar)
        return self

    def score_brute_force(self, quantize=cfg.FLOAT32) -> "ScannBuilder":
        """Configure exact scoring: float32, int8 or bfloat16 rows, alone
        (brute force) or as a tree's leaves (int8: residual tree-SQ)."""
        if self._bf is not None:
            raise ValueError("score_bf has already been configured")
        self._bf = cfg.BruteForceConfig(quantize=_quantize_name(quantize))
        return self

    def upper_tree(self, num_leaves, num_leaves_to_search,
                   avq=float("nan"), soar_lambda=None,
                   overretrieve_factor=None, scoring_mode=cfg.INT8,
                   anisotropic_quantization_threshold=float("nan")
                   ) -> "ScannBuilder":
        """Configure a second tree level over the leaf centers (requires
        tree()): queries score only the leaves of their best
        ``num_leaves_to_search`` upper clusters.  ``avq`` refits the upper
        centers, ``soar_lambda`` gives each leaf a second upper cluster."""
        if self._upper_tree is not None:
            raise ValueError("upper_tree has already been configured")
        del anisotropic_quantization_threshold
        self._upper_tree = cfg.UpperTreeConfig(
            num_leaves=num_leaves, num_leaves_to_search=num_leaves_to_search,
            avq=None if (isinstance(avq, float) and math.isnan(avq))
            else avq,
            soar_lambda=soar_lambda,
            overretrieve_factor=overretrieve_factor,
            scoring_mode=_quantize_name(scoring_mode))
        return self

    def score_ah(self, dimensions_per_block,
                 anisotropic_quantization_threshold=float("nan"),
                 training_sample_size=100000, min_cluster_size=100,
                 hash_type="lut16", training_iterations=10,
                 quantization_scheme="product",
                 variable_dims_per_block=None) -> "ScannBuilder":
        """Configure asymmetric hashing (same arguments as the JAX
        package; the factory raises for the settings not ported yet)."""
        del min_cluster_size  # deprecated
        if self._ah is not None:
            raise ValueError("score_ah has already been configured")
        self._ah = cfg.AsymmetricHashConfig(
            dimensions_per_block=dimensions_per_block,
            variable_dims_per_block=(
                None if variable_dims_per_block is None
                else tuple(int(w) for w in variable_dims_per_block)),
            anisotropic_quantization_threshold=(
                anisotropic_quantization_threshold),
            training_sample_size=training_sample_size,
            hash_type=hash_type,
            training_iterations=training_iterations,
            quantization_scheme=quantization_scheme)
        return self

    def reorder(self, reordering_num_neighbors, quantize=cfg.FLOAT32,
                anisotropic_quantization_threshold=float("nan")
                ) -> "ScannBuilder":
        """Configure exact reordering of the best candidates."""
        if self._reorder is not None:
            raise ValueError("reorder has already been configured")
        self._reorder = cfg.ReorderConfig(
            reordering_num_neighbors=reordering_num_neighbors,
            quantize=_quantize_name(quantize),
            anisotropic_quantization_threshold=(
                anisotropic_quantization_threshold))
        return self

    def pca(self, *args, **kwargs):
        base.not_ported("pca projection", 16)

    def opq(self, *args, **kwargs):
        base.not_ported("opq projection", 16)

    def truncate(self, *args, **kwargs):
        base.not_ported("truncate projection", 16)

    def autopilot(self, *args, **kwargs):
        base.not_ported("autopilot", 17)

    def create_config(self) -> cfg.ScannConfig:
        """Resolve the typed config."""
        if self.distance_measure not in (cfg.DOT_PRODUCT, cfg.SQUARED_L2,
                                         cfg.COSINE, cfg.L1):
            raise ValueError(
                "distance_measure must be one of ['dot_product',"
                " 'squared_l2', 'cosine', 'l1']")
        ah = self._ah
        if ah is not None and ah.residual_quantization is None:
            # Residual quantization is on for partitioned dot product.
            residual = (self._partitioning is not None
                        and cfg.internal_measure(self.distance_measure)
                        == cfg.DOT_PRODUCT)
            ah = cfg.AsymmetricHashConfig(
                **{**ah.__dict__, "residual_quantization": residual})
        partitioning = self._partitioning
        if self._upper_tree is not None:
            if partitioning is None:
                raise ValueError("upper_tree requires tree() to be set")
            partitioning = cfg.PartitioningConfig(
                **{**partitioning.__dict__, "upper_tree": self._upper_tree})
        return cfg.ScannConfig(
            num_neighbors=self.num_neighbors,
            distance_measure=self.distance_measure,
            partitioning=partitioning,
            asymmetric_hash=ah,
            brute_force=self._bf,
            reordering=self._reorder,
            seed=self.seed)

    def build(self, docids=None):
        """Create the searcher on the builder's device."""
        from scann_torch import factory
        return factory.create_searcher(self.db, self.create_config(),
                                       self.device, docids=docids)


def builder(db, num_neighbors, distance_measure,
            device="cuda") -> ScannBuilder:
    """pybind-style builder entry point; the index lives on ``device``
    (CUDA by default; pass device="cpu" for the plain CPU path)."""
    return ScannBuilder(db, num_neighbors, distance_measure, device=device)
