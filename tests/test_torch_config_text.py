"""Reference ScannConfig text protos (ROADMAP item 17): the cases of
tests/test_config_text.py through both packages -- equal parse dicts,
equal canonicalized configs, the same exception types -- and the port's
searcher built from a text proto on the CPU."""

import dataclasses
import math

import numpy as np
import pytest

import scann_torch
import scann_tpu
from scann_torch.utils import config_text as tct
from scann_tpu.utils import config_text as jct
import torch_threads  # noqa: F401  (torch threads per xdist worker)

NOTEBOOK_STYLE = """
  num_neighbors: 10
  distance_measure {distance_measure: "DotProductDistance"}
  partitioning {
    num_children: 32
    min_cluster_size: 20
    max_clustering_iterations: 8
    single_machine_center_initialization: RANDOM_INITIALIZATION
    partitioning_distance {
      distance_measure: "SquaredL2Distance"
    }
    query_spilling {
      spilling_type: FIXED_NUMBER_OF_CENTERS
      max_spill_centers: 8
    }
    expected_sample_size: 6000
    query_tokenization_distance_override {distance_measure: "DotProductDistance"}
    partitioning_type: GENERIC
    query_tokenization_type: FLOAT
  }
  hash {
    asymmetric_hash {
      lookup_type: INT8_LUT16
      use_residual_quantization: True
      use_global_topn: True
      quantization_distance {
        distance_measure: "SquaredL2Distance"
      }
      num_clusters_per_block: 16
      projection {
        input_dim: 32
        projection_type: CHUNK
        num_blocks: 16
        num_dims_per_block: 2
      }
      fixed_point_lut_conversion_options {
        float_to_int_conversion_method: ROUND
      }
      noise_shaping_threshold: 0.2
      expected_sample_size: 6000
      max_clustering_iterations: 6
    }
  }
  exact_reordering {
    approx_num_neighbors: 50
    fixed_point {
      enabled: False
      noise_shaping_threshold: nan
    }
  }
"""

SOAR_VARIABLE = """
  num_neighbors: 10
  distance_measure {distance_measure: "DotProductDistance"}
  partitioning {
    num_children: 16
    query_spilling {
      spilling_type: FIXED_NUMBER_OF_CENTERS
      max_spill_centers: 4
    }
    expected_sample_size: 6000
    database_spilling {
      spilling_type: TWO_CENTER_ORTHOGONALITY_AMPLIFIED
      orthogonality_amplification_lambda: 1.5
      overretrieve_factor: 2.0
    }
  }
  hash {
    asymmetric_hash {
      lookup_type: INT8_LUT16
      num_clusters_per_block: 16
      projection {
        input_dim: 30
        projection_type: VARIABLE_CHUNK
        variable_blocks {
          num_blocks: 7
          num_dims_per_block: 4
        }
        variable_blocks {
          num_blocks: 1
          num_dims_per_block: 2
        }
      }
      noise_shaping_threshold: nan
      expected_sample_size: 6000
    }
  }
"""

BRUTE_FORCE_BF16 = """
  num_neighbors: 5
  distance_measure {distance_measure: "SquaredL2Distance"}
  brute_force {
    fixed_point {
      enabled: True
    }
  }
  exact_reordering {
    approx_num_neighbors: 30
    bfloat16 {
      enabled: True
    }
  }
"""

AUTOPILOT = """
  num_neighbors: 10
  distance_measure {distance_measure: "DotProductDistance"}
  autopilot {
    tree_ah {
      incremental_mode: ONLINE_INCREMENTAL
      reordering_dtype: INT8
    }
  }
"""

# Settings the other cases leave out: query spilling, a PCA / truncate
# projection, an upper tree, incremental training, AVQ, spherical int8
# centroids and the 256-center lookups.
EXTRAS = """
  num_neighbors: 7
  distance_measure {distance_measure: "DotProductDistance"}
  partitioning {
    num_children: 40
    partitioning_type: SPHERICAL
    query_tokenization_type: FIXED_POINT_INT8
    single_machine_center_initialization: DEFAULT_KMEANS_PLUS_PLUS
    query_spilling {
      spilling_type: ADDITIVE
      spilling_threshold: 0.25
      max_spill_centers: 6
    }
    incremental_training_config { fraction: 0.2 }
    avq: 2.0
    projection { projection_type: PCA num_dims_per_block: 16 }
    bottom_up_top_level_partitioner {
      enabled: true
      num_centroids: 8
      num_centroids_to_search: 3
      quantization: BFLOAT16
      soar { enabled: true lambda: 1.2 }
    }
  }
  hash { asymmetric_hash { lookup_type: FLOAT num_clusters_per_block: 256
    projection { num_dims_per_block: 4 } } }
  exact_reordering {
    approx_num_neighbors: 40
    fixed_point { enabled: true noise_shaping_threshold: 0.3 }
  }
"""

TRUNCATE = """
  num_neighbors: 3
  distance_measure {distance_measure: "CosineDistance"}
  partitioning {
    num_children: 8
    query_spilling { spilling_type: MULTIPLICATIVE spilling_threshold: 1.5 }
    incremental_training_config { number_of_datapoints: 500 }
    projection { projection_type: TRUNCATE num_dims_per_block: 24 }
  }
  brute_force { }
"""

CASES = {"notebook": NOTEBOOK_STYLE, "soar_variable": SOAR_VARIABLE,
         "brute_force_bf16": BRUTE_FORCE_BF16, "autopilot": AUTOPILOT,
         "extras": EXTRAS, "truncate": TRUNCATE}


def make_db(n=600, d=32, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((n, d)).astype(np.float32)
    return db / np.linalg.norm(db, axis=1, keepdims=True)


def _same(a, b):
    """Parse dicts equal, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_and_canonical_config_equal_jax(name):
    text = CASES[name]
    assert _same(tct.parse_textproto(text), jct.parse_textproto(text))
    db = make_db(d=30 if name == "soar_variable" else 32)
    got = tct.builder_from_pbtxt(db, text, device="cpu").create_config()
    want = jct.builder_from_pbtxt(db, text).create_config()
    assert got.to_json() == want.to_json()
    b = scann_torch.builder_from_pbtxt(db, text, device="cpu")
    assert b.device.type == "cpu"
    assert b.create_config().to_json() == want.to_json()


def test_notebook_config_builds_the_native_builders_searcher():
    db = make_db(2000)
    q = make_db(32, seed=1)
    s = scann_torch.searcher_from_pbtxt(db, NOTEBOOK_STYLE, device="cpu")
    native = (scann_torch.builder(db, 10, "dot_product", device="cpu")
              .tree(num_leaves=32, num_leaves_to_search=8,
                    training_sample_size=6000, min_partition_size=20,
                    training_iterations=8)
              .score_ah(2, anisotropic_quantization_threshold=0.2,
                        training_sample_size=6000, training_iterations=6)
              .reorder(50).create_config())
    assert s.config.to_json() == dataclasses.replace(
        native, partitioning=dataclasses.replace(
            native.partitioning,
            num_leaves=s.part_cfg.num_leaves)).to_json()
    assert s.device.type == "cpu"
    idx, dist = s.search_batched(q)
    truth = np.argsort(-(q @ db.T), axis=1)[:, :10]
    # Exact reorder of 50 candidates from a quarter of the leaves.
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(idx, truth)])
    assert recall >= 0.5, recall
    np.testing.assert_allclose(
        dist, np.take_along_axis(q @ db.T, idx, axis=1), rtol=1e-5)


def test_brute_force_text_searches():
    db = make_db(500)
    s = scann_torch.searcher_from_pbtxt(db, BRUTE_FORCE_BF16, device="cpu")
    idx, dist = s.search_batched(db[:4])
    assert idx.shape == (4, 5) and (idx[:, 0] == np.arange(4)).all()


_BAD = [
    ("builder", "brute_force { }"),
    ("builder", 'num_neighbors: 5\n'
                'distance_measure {distance_measure: "Chebyshev"}\n'
                'brute_force { }'),
    ("builder", 'num_neighbors: 5\n'
                'distance_measure {distance_measure: "DotProductDistance"}'),
    ("parse", "partitioning { num_children: 3"),
    ("parse", "}"),
    ("parse", "a { b: }"),
    ("parse", "a b"),
    ("builder", 'num_neighbors: 5\npartitioning { num_children: 4 '
                'query_spilling { spilling_type: BOGUS } }\nbrute_force { }'),
    ("builder", 'num_neighbors: 5\nhash { asymmetric_hash { '
                'lookup_type: BOGUS } }'),
    ("builder", 'num_neighbors: 5\npartitioning { num_children: 4 '
                'projection { projection_type: RANDOM } }\nbrute_force { }'),
    ("builder", 'num_neighbors: 5\nautopilot { tree_ah { '
                'incremental_mode: SOMETIMES } }'),
]


@pytest.mark.parametrize("i", range(len(_BAD)))
def test_same_exceptions_as_jax(i):
    kind, text = _BAD[i]
    db = make_db(100)

    def run(mod, **kw):
        if kind == "parse":
            return mod.parse_textproto(text)
        return mod.builder_from_pbtxt(db, text, **kw)

    with pytest.raises(Exception) as want:
        run(jct)
    with pytest.raises(type(want.value)) as got:
        run(tct, device="cpu")
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_jax_package_still_builds_from_text():
    """Both packages read the same text: the JAX builder for the same
    corpus (config only, no build) is the one the port copies."""
    db = make_db()
    assert scann_tpu.builder_from_pbtxt(db, NOTEBOOK_STYLE).create_config(
    ).to_json() == scann_torch.builder_from_pbtxt(
        db, NOTEBOOK_STYLE, device="cpu").create_config().to_json()
