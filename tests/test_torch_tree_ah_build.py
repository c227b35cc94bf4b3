"""Build parity of the tree-AH slice against scann_tpu (split from
tests/test_torch_tree_ah.py, which holds the search parity on JAX-built
indexes and the helpers both files use, so that pytest-xdist's
``--dist loadfile`` runs the two halves on two workers).

A port-built index is held to the JAX-built index's recall@10 (within
0.02), and scann_tpu loads the port's saved index and returns the port's
results; the builder's config equals the JAX builder's; an incremental
tree-AH index takes an upsert past its threshold; and the settings that
once refused beside an autopilot config build through the JAX package's
autopilot rewrite."""

import dataclasses

import numpy as np
import pytest
import torch

import scann_torch
import scann_tpu
from test_torch_tree_ah import CASES, _assert_same, _clustered, _config, \
    _recall
import torch_threads  # noqa: F401  (torch threads per xdist worker)

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def data():
    return _clustered()


@pytest.mark.parametrize("case", ["dot_int8_f32", "l2_int8_bf16",
                                  "dot_float_int8", "dot_lut256_f32"])
def test_build_parity_and_cross_load(data, case, tmp_path):
    db, q = data
    measure = CASES[case][0]
    sim = q @ db.T if measure == "dot_product" else -(
        (q ** 2).sum(1)[:, None] - 2 * q @ db.T + (db ** 2).sum(1)[None])
    truth = np.argsort(-sim, axis=1)[:, :10]
    # A wide pre-reorder budget: recall then measures the index, not the
    # luck of the cut.
    js = scann_tpu.create_searcher(
        db, _config(scann_tpu.builder, case, reorder_k=60, db=db))
    ts = scann_torch.create_searcher(
        db, _config(scann_torch.builder, case, reorder_k=60, db=db,
                    device="cpu"), "cpu")
    assert type(ts).__name__ == "TreeAHSearcher"
    assert ts.index.slot_dpid.dtype == torch.int32
    assert ts._host["codes"].dtype == np.uint8
    assert abs(np.sqrt(ts._quantization_error_sq)
               - np.sqrt(js._quantization_error_sq)) < 0.05
    for leaves in (6, 12, ts.partitioner.num_leaves):
        rj = _recall(js.search_batched(q, leaves_to_search=leaves)[0], truth)
        got = ts.search_batched(q, leaves_to_search=leaves)
        rt = _recall(got[0], truth)
        assert abs(rt - rj) <= 0.02, (leaves, rt, rj)
    got = ts.search_batched(q, leaves_to_search=6)
    ts.serialize(str(tmp_path))
    back = scann_tpu.load_searcher(str(tmp_path))
    assert back._pruned_available
    _assert_same(got, back.search_batched(q, leaves_to_search=6), measure)
    again = scann_torch.load_searcher(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(
        again.search_batched(q, leaves_to_search=6)[0], got[0])


def test_builder_config_matches_jax_builder(data):
    db, _ = data
    for case in sorted(CASES):
        assert (_config(scann_torch.builder, case, db=db,
                        device="cpu").to_json()
                == _config(scann_tpu.builder, case, db=db).to_json())


def _ah(b, **kw):
    return b.tree(num_leaves=4, num_leaves_to_search=2).score_ah(2, **kw)


def _with_autopilot(config):
    return dataclasses.replace(
        config, autopilot=scann_torch.config.AutopilotConfig())


_AUTOPILOT = {
    # Stacked and variable-chunk codes, the single-leaf tree and
    # non-residual int8 reordering through a projection, each beside an
    # autopilot config: the factory rewrites it (ROADMAP item 17) into the
    # JAX package's config, which replaces the rest.
    "stacked": lambda b: _with_autopilot(b.tree(
        num_leaves=4, num_leaves_to_search=2)
        .score_ah(2, quantization_scheme="stacked").create_config()),
    "variable_chunks": lambda b: _with_autopilot(b.tree(
        num_leaves=4, num_leaves_to_search=2)
        .score_ah(2, variable_dims_per_block=[2, 2, 4]).create_config()),
    "single_leaf_tree": lambda b: _with_autopilot(b.tree(
        num_leaves=1, num_leaves_to_search=1)
        .score_ah(2).create_config()),
    "reorder_int8_raw": lambda b: dataclasses.replace(
        _ah(b).reorder(10, quantize="int8").create_config(),
        reordering=scann_torch.ReorderConfig(
            reordering_num_neighbors=10, quantize="int8", residual=False),
        projection=scann_torch.config.ProjectionConfig(),
        autopilot=scann_torch.config.AutopilotConfig()),
}


def test_mutation_builds_and_searches():
    """A tree-AH index under the incremental threshold (ROADMAP item 15)
    builds with docids, searches, and takes an upsert past its threshold
    (a rebalance); tests/test_torch_mutation*.py hold it against
    scann_tpu."""
    db = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    config = (scann_torch.builder(db, 3, "dot_product", device="cpu")
              .tree(num_leaves=4, num_leaves_to_search=2,
                    incremental_threshold=0.1).score_ah(2).create_config())
    s = scann_torch.create_searcher(db, config, "cpu",
                                    docids=list(range(64)))
    idx, dist = s.search_batched(db[:4])
    assert len(idx) == 4 and all(row[0] is not None for row in idx)
    s.upsert(list(range(64, 72)), db[:8] * 2)      # 8 > 0.1 * 72
    assert s._mut.mutations_since_rebuild == 0 and s.n_points == 72
    assert s.docids == list(range(72))
    assert set(s.search(db[3] * 2)[0]) <= set(range(72))


@pytest.mark.parametrize("name", sorted(_AUTOPILOT))
def test_autopilot_tree_ah_settings_build_and_search(name):
    import json
    from scann_tpu import config as jcfg
    from scann_tpu.utils import autopilot as jap
    db = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    config = _AUTOPILOT[name](scann_torch.builder(db, 3, "dot_product",
                                                  device="cpu"))
    s = scann_torch.create_searcher(db, config, "cpu")
    want = jap.autopilot_rewrite(
        jcfg._config_from_dict(json.loads(config.to_json())), db)
    assert s.config.to_json() == want.to_json()
    # A 64-row corpus rewrites to brute force: exact dot products.
    idx, dist = s.search_batched(db[:4])
    assert idx.shape == (4, 3)
    np.testing.assert_array_equal(idx[:, 0], (db[:4] @ db.T).argmax(1))
    assert np.isfinite(dist).all()
