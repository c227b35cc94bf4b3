"""scann_torch.config against scann_tpu.config: the JSON a config writes
is byte-for-byte the same in both packages, and each reads the other's."""

import pytest

import scann_torch.config as tcfg
import scann_tpu
import scann_tpu.config as jcfg


def _configs():
    db = [[0.0] * 8] * 4
    b = scann_tpu.builder
    return {
        "tree_sq": b(db, 10, "dot_product").tree(
            num_leaves=2000, num_leaves_to_search=100,
            training_sample_size=250_000).score_brute_force(
                quantize="int8").create_config(),
        "tree_sq_l2": b(db, 5, "squared_l2").tree(
            num_leaves=32, num_leaves_to_search=4, spherical=True,
            random_init=False).score_brute_force(
                quantize="int8").create_config(),
        "brute_force": b(db, 10, "dot_product").score_brute_force()
        .create_config(),
        "tree_ah": b(db, 10, "dot_product").tree(
            num_leaves=2000, num_leaves_to_search=100,
            training_sample_size=250_000).score_ah(
                2, anisotropic_quantization_threshold=0.2).reorder(
                    100).create_config(),
        "tree_ah_l2_int8": b(db, 10, "squared_l2").tree(
            num_leaves=32, num_leaves_to_search=4).score_ah(
                4, hash_type="lut256", training_sample_size=5000).reorder(
                    50, quantize="int8").create_config(),
        "tree_ah_reorder": b(db, 10, "dot_product").tree(
            num_leaves=16, num_leaves_to_search=2, soar_lambda=1.5,
            query_spilling_type="additive").score_ah(
                2, anisotropic_quantization_threshold=0.2).reorder(
                    50, quantize="int8").create_config(),
        "upper_tree_pca": b(db, 10, "squared_l2").tree(
            num_leaves=64, num_leaves_to_search=8).upper_tree(
                8, 2).score_ah(2).pca(
                    reduction_dim=4,
                    pca_significance_threshold=None).create_config(),
        "autopilot": b(db, 10, "dot_product").autopilot(
            engine="tree_sq").create_config(),
    }


@pytest.mark.parametrize("name", ["tree_sq", "tree_sq_l2", "brute_force",
                                  "tree_ah_reorder", "upper_tree_pca",
                                  "autopilot", "tree_ah", "tree_ah_l2_int8"])
def test_json_round_trip_both_ways(name):
    jax_cfg = _configs()[name]
    text = jax_cfg.to_json()
    port_cfg = tcfg.ScannConfig.from_json(text)
    assert port_cfg.to_json() == text
    back = jcfg.ScannConfig.from_json(port_cfg.to_json())
    # JSON, not dataclass equality: unset AH thresholds are NaN.
    assert back.to_json() == text
    assert type(back) is jcfg.ScannConfig


def test_port_builder_config_matches_jax_builder():
    import numpy as np
    import scann_torch
    db = np.zeros((4, 8), np.float32)
    port = (scann_torch.builder(db, 10, "dot_product", device="cpu")
            .tree(num_leaves=2000, num_leaves_to_search=100,
                  training_sample_size=250_000)
            .score_brute_force(quantize="int8").create_config())
    assert port.to_json() == _configs()["tree_sq"].to_json()


def test_port_builder_tree_ah_config_matches_jax_builder():
    """score_ah / reorder and the residual auto-on rule (on for partitioned
    dot product, off under squared L2)."""
    import numpy as np
    import scann_torch
    db = np.zeros((4, 8), np.float32)
    port = (scann_torch.builder(db, 10, "dot_product", device="cpu")
            .tree(num_leaves=2000, num_leaves_to_search=100,
                  training_sample_size=250_000)
            .score_ah(2, anisotropic_quantization_threshold=0.2)
            .reorder(100).create_config())
    assert port.to_json() == _configs()["tree_ah"].to_json()
    assert port.asymmetric_hash.residual_quantization is True
    port = (scann_torch.builder(db, 10, "squared_l2", device="cpu")
            .tree(num_leaves=32, num_leaves_to_search=4)
            .score_ah(4, hash_type="lut256", training_sample_size=5000)
            .reorder(50, quantize="int8").create_config())
    assert port.to_json() == _configs()["tree_ah_l2_int8"].to_json()
    assert port.asymmetric_hash.residual_quantization is False
