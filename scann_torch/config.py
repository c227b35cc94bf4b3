"""Typed configuration tree for scann_torch searchers.

A copy of scann_tpu/config.py (the port imports nothing of the JAX
package, so it keeps its own copy; its comments describe what each
setting does on any device).  The dataclasses, ``to_json`` and
``_config_from_dict`` must stay byte-for-byte compatible with the JAX
package: both packages read and write each other's ``scann_config.json``
(tests/test_torch_config.py holds the round trip).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Optional

DOT_PRODUCT = "dot_product"
SQUARED_L2 = "squared_l2"
COSINE = "cosine"
L1 = "l1"  # brute-force only (reference: the factory accepts L1 for
# non-hashed searchers, distance_measures/one_to_one/l1_distance.cc)
_ALLOWED_MEASURES = (DOT_PRODUCT, SQUARED_L2, COSINE, L1)


def internal_measure(measure: str) -> str:
    """Cosine runs as dot product over L2-normalized data (the reference
    treats angular data the same way; returned distances are 1 - cos)."""
    return DOT_PRODUCT if measure == COSINE else measure

FLOAT32 = "float32"
INT8 = "int8"
BFLOAT16 = "bfloat16"
_ALLOWED_QUANTIZE = (FLOAT32, INT8, BFLOAT16)


@dataclasses.dataclass(frozen=True)
class SoarConfig:
    """SOAR two-center spilled assignment (reference:
    scann/proto/partitioning.proto:192-218, DatabaseSpillingConfig with
    spilling_type TWO_CENTER_ORTHOGONALITY_AMPLIFIED)."""

    lambda_: float = 1.5
    overretrieve_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class UpperTreeConfig:
    """Second-level partitioner over the leaf centroids, making query
    tokenization itself approximate (reference: BottomUpTopLevelPartitioner,
    proto/partitioning.proto:282-313, TreeBruteForceSecondLevelWrapper,
    tree_brute_force_second_level_wrapper.h:44-100; builder upper_tree,
    scann_builder.py:133-161).  It makes tokenization cheaper at the cost
    of recall, so it pays at large leaf counts; the quantization/soar/avq
    sub-knobs of the reference's upper tree are accepted for API parity
    but the centroid search runs as one masked matmul."""

    num_leaves: int = 0
    num_leaves_to_search: int = 1
    avq: Optional[float] = None
    soar_lambda: Optional[float] = None
    overretrieve_factor: Optional[float] = None
    scoring_mode: str = INT8


@dataclasses.dataclass(frozen=True)
class PartitioningConfig:
    """K-means tree partitioning (reference: scann/proto/partitioning.proto,
    assembled by ScannBuilder.tree, scann_builder.py:163-239)."""

    num_leaves: int = 0
    num_leaves_to_search: int = 1
    training_sample_size: int = 100000  # expected_sample_size
    min_partition_size: int = 50  # min_cluster_size
    training_iterations: int = 12  # max_clustering_iterations
    spherical: bool = False  # partitioning_type SPHERICAL vs GENERIC
    quantize_centroids: bool = False  # query_tokenization_type FIXED_POINT_INT8
    random_init: bool = True  # RANDOM_INITIALIZATION vs KMEANS_PLUS_PLUS
    # Query tokenization distance: the reference overrides it with the top
    # level distance measure (scann_builder.py:230).  Resolved at build time.
    avq: Optional[float] = None  # AVQ eta; dot product only
    soar: Optional[SoarConfig] = None
    incremental_threshold: Optional[float] = None
    # "online": threshold crossings trigger a full retrain (reference
    # ONLINE mode); "online_incremental": split oversized partitions and
    # reassign only their members (reference ONLINE_INCREMENTAL,
    # tree_x_hybrid/mutator.h SplitPartition/Reassign :560-737).
    incremental_mode: str = "online"
    # Query spilling (reference QuerySpillingConfig,
    # proto/partitioning.proto:220-237): "fixed_number" |
    # "additive" | "multiplicative" | "absolute_distance".
    # num_leaves_to_search doubles as max_spill_centers for the
    # distance-conditioned types; a None threshold for additive/
    # multiplicative is LEARNED from the training sample
    # (GmmUtils::ComputeSpillingThreshold, gmm_utils.cc:946) targeting
    # expected_spill_factor leaves per query.
    query_spilling_type: str = "fixed_number"
    query_spilling_threshold: Optional[float] = None
    expected_spill_factor: float = 2.0
    upper_tree: Optional[UpperTreeConfig] = None
    # Hierarchical center TRAINING for large leaf counts (reference:
    # KMeansTreeNode::Train recursion, trees/kmeans_tree/kmeans_tree_node
    # .cc:163-265): train `hierarchical_top` top-level clusters, then one
    # sub-k-means per top cluster; the top level doubles as the upper
    # tree.  0 disables; "auto" picks ~sqrt(num_leaves) when num_leaves
    # is large.  Training cost drops from O(sample * num_leaves) to
    # O(sample * (top + num_leaves/top)) per iteration.
    hierarchical_top: int = 0

    def __post_init__(self):
        if self.num_leaves <= 0:
            raise ValueError("num_leaves must be positive")
        if not (0 < self.num_leaves_to_search <= self.num_leaves):
            raise ValueError(
                "num_leaves_to_search must be in (0, num_leaves]")


@dataclasses.dataclass(frozen=True)
class AsymmetricHashConfig:
    """Product-quantization / asymmetric hashing scoring (reference:
    scann/proto/hash.proto AsymmetricHasherConfig, assembled by
    ScannBuilder.score_ah, scann_builder.py:241-320)."""

    dimensions_per_block: int = 2
    # VARIABLE_CHUNK (reference projection/chunking_projection.h:40-90):
    # per-block widths summing to the dimensionality; overrides
    # dimensions_per_block when set.
    variable_dims_per_block: Optional[tuple] = None
    anisotropic_quantization_threshold: float = math.nan  # noise_shaping_threshold
    training_sample_size: int = 100000  # expected_sample_size
    hash_type: str = "lut16"  # lut16 (16 centers/block) | lut256
    training_iterations: int = 10  # max_clustering_iterations
    # PRODUCT (disjoint dimension blocks) or STACKED (additive full-dim
    # codebooks; reference quantization_scheme STACKED ->
    # hashes/internal/stacked_quantizers.h).
    quantization_scheme: str = "product"
    # None => resolved at build: residual quantization iff partitioned and
    # dot-product distance (scann_builder.py:428-432).
    residual_quantization: Optional[bool] = None
    # Fixed-point LUT conversion (reference: ConvertLookupToFixedPoint,
    # hashes/internal/asymmetric_hashing_impl.cc:604-646): quantile 1.0 means
    # scale by max |lut| entry.
    lut_multiplier_quantile: float = 1.0
    # Scoring mode for the packed codes:
    #   "int8"/"float32": LUT16 lookup via one-hot matmuls (reference
    #     INT8_LUT16 / FLOAT lookup semantics, memory-lean);
    #   "reconstruct": decode the same 4-bit codes into bf16 rows at build
    #     and score with a plain bf16 matrix product — the same information
    #     (and recall) as a float LUT, at the cost of keeping bf16 rows in
    #     device memory.  The reference has no equivalent.
    lookup_type: str = INT8

    @property
    def clusters_per_block(self) -> int:
        if self.hash_type == "lut16":
            return 16
        if self.hash_type == "lut256":
            return 256
        raise ValueError(f"hash_type must be lut16 or lut256: {self.hash_type}")


@dataclasses.dataclass(frozen=True)
class BruteForceConfig:
    """Exact scoring (reference: scann/proto/brute_force.proto, assembled by
    ScannBuilder.score_brute_force, scann_builder.py:322-335)."""

    quantize: str = FLOAT32  # float32 | int8 | bfloat16


@dataclasses.dataclass(frozen=True)
class ReorderConfig:
    """Exact reordering of top AH candidates (reference:
    scann/proto/exact_reordering.proto, ScannBuilder.reorder,
    scann_builder.py:337-359)."""

    reordering_num_neighbors: int = 100  # approx_num_neighbors
    quantize: str = FLOAT32  # float32 | int8 | bfloat16
    anisotropic_quantization_threshold: float = math.nan
    # int8 + partitioned (unprojected) searchers quantize RESIDUALS
    # x - c_primary and add the exact q.c_leaf back at rescore time (no
    # reference analogue): residual norms are a fraction of
    # row norms on clustered data, so the int8 steps are several times
    # finer at +4 B/vector.  Set False for the reference's raw-row
    # fixed-point behavior.
    residual: bool = True


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    """Input projection (reference: scann/proto/projection.proto; PCA and
    TRUNCATE variants from ScannBuilder.pca/truncate,
    scann_builder.py:90-131)."""

    # pca | truncate | random_orthogonal | eigenvalue_opq
    projection_type: str = "truncate"
    reduction_dim: Optional[int] = None
    pca_significance_threshold: Optional[float] = 0.8
    pca_truncation_threshold: Optional[float] = 0.6
    # eigenvalue_opq: AH blocks the rotation feeds (resolved by the
    # builder from dimensions_per_block when unset).
    opq_num_blocks: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class AutopilotConfig:
    """Autopilot config rewriting (reference: scann/proto/auto_tuning.proto,
    utils/single_machine_autopilot.cc:35-200)."""

    incremental_mode: str = "none"  # none | online | online_incremental
    reordering_dtype: str = FLOAT32
    # "tree_ah" reproduces the reference's AutopilotTreeAh; "tree_sq"
    # picks pruned exact residual-int8 leaves (ops/pruned_sq.py) with no
    # reorder, dot product and cosine only.
    engine: str = "tree_ah"        # tree_ah | tree_sq
    # "tpu" (the JAX package's name) sizes leaves at about 500 rows,
    # caps the leaf count by the tokenization product's size and takes
    # leaves_to_search from a scanned-fraction curve toward
    # target_recall (utils/autopilot.py); "reference" keeps the verbatim
    # AutopilotTreeAh cache heuristics (single_machine_autopilot.cc:35-200)
    # as a parity mode.
    heuristics: str = "tpu"        # tpu | reference
    # Recall@10 the "tpu" heuristics aim for (sets leaves_to_search from
    # the recall curves of utils/autopilot.py).
    target_recall: float = 0.95


@dataclasses.dataclass(frozen=True)
class ScannConfig:
    """Top-level config, equivalent of the reference's ScannConfig textproto
    (scann/proto/scann.proto:33)."""

    num_neighbors: int = 10
    distance_measure: str = DOT_PRODUCT
    partitioning: Optional[PartitioningConfig] = None
    asymmetric_hash: Optional[AsymmetricHashConfig] = None
    brute_force: Optional[BruteForceConfig] = None
    reordering: Optional[ReorderConfig] = None
    projection: Optional[ProjectionConfig] = None
    autopilot: Optional[AutopilotConfig] = None
    seed: int = 42

    def __post_init__(self):
        if self.distance_measure not in _ALLOWED_MEASURES:
            raise ValueError(
                f"distance_measure must be one of {_ALLOWED_MEASURES}, got "
                f"{self.distance_measure!r}")
        if self.autopilot is None:
            if (self.asymmetric_hash is None) == (self.brute_force is None):
                raise ValueError(
                    "Exactly 1 of score_ah or score_brute_force must be set")
        if self.distance_measure == L1:
            # Like the reference's factory, non-decomposable measures are
            # brute-force only (no AH LUTs, no matmul reordering).
            if (self.asymmetric_hash is not None
                    or self.partitioning is not None
                    or self.reordering is not None):
                raise ValueError(
                    "l1 distance supports brute-force search only "
                    "(no tree/score_ah/reorder)")
            if (self.brute_force is not None
                    and self.brute_force.quantize != FLOAT32):
                raise ValueError(
                    "l1 brute force requires float32 (no quantized L1 "
                    "kernels)")

    # ------------------------------------------------------------------ JSON
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "ScannConfig":
        raw = json.loads(text)
        return _config_from_dict(raw)


def _build(cls, raw: Optional[dict]) -> Any:
    if raw is None:
        return None
    return cls(**raw)


def _config_from_dict(raw: dict) -> ScannConfig:
    part = raw.get("partitioning")
    if part is not None:
        soar = _build(SoarConfig, part.pop("soar", None))
        upper = _build(UpperTreeConfig, part.pop("upper_tree", None))
        part = PartitioningConfig(**part, soar=soar, upper_tree=upper)
    return ScannConfig(
        num_neighbors=raw["num_neighbors"],
        distance_measure=raw["distance_measure"],
        partitioning=part,
        asymmetric_hash=_build(AsymmetricHashConfig, raw.get("asymmetric_hash")),
        brute_force=_build(BruteForceConfig, raw.get("brute_force")),
        reordering=_build(ReorderConfig, raw.get("reordering")),
        projection=_build(ProjectionConfig, raw.get("projection")),
        autopilot=_build(AutopilotConfig, raw.get("autopilot")),
        seed=raw.get("seed", 42),
    )
