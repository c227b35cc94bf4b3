"""Reordering on tree-SQ and on brute force, and the int8 quantizers it
stores, against scann_tpu on the CPU.

* ``ops/quantize``: on the same arrays, int8 rows equal and multipliers
  within 1e-6 relative, with and without noise shaping (and with the
  direction rows of a residual), at the full bound and at a quantile.
* Search, on the same serialized index, both directions, to the bar of
  tests/test_torch_brute_force.py (>= 99.9% of the top-10 ids found in
  the other package's top 10,
  distances within 1e-4 relative, squared L2 relative to |d| + ||q||^2 +
  ||x||^2): tree-SQ (residual int8 leaves, the pruned path through K1's
  plain version) with float32, bfloat16, residual int8, per-dimension
  int8 and noise-shaped per-dimension int8 reorder rows, and bfloat16
  brute force with noise-shaped int8 reorder rows (int8 reordering
  without a tree), under dot product and squared L2; the JAX-built index
  searched with the config's defaults, the port-built one with 6 leaves
  and 50 candidates reordered.  The rows are unit
  vectors, as in tests/test_torch_search.py: the JAX package loses the
  slot of an exactly-zero tree-SQ score on the CPU (ROADMAP section 3), so
  no row may equal its leaf center.
* Build, statistically: a port-built tree-SQ + reorder(30) index's
  recall@10 is within 1 pt of the JAX-built one's on the same data."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scann_torch
import scann_tpu
from scann_torch.ops import quantize as tq
from scann_tpu.ops import quantize as jq
from tests.test_torch_brute_force import assert_same
import torch_threads  # noqa: F401  (torch threads per xdist worker)


# Noise shaping changes rows only where eta(T) > 1, T^2 over a fair share
# of ||x||^2 (about 72 here).
@pytest.mark.parametrize("threshold,quantile,residual", [
    (float("nan"), 1.0, False), (float("nan"), 0.99, False),
    (4.0, 1.0, False), (4.0, 1.0, True)])
def test_quantizers_match_the_jax_package(threshold, quantile, residual):
    r = np.random.default_rng(5)
    x = (r.standard_normal((2000, 24)) * r.uniform(0.2, 3.0, 24)).astype(
        np.float32)
    o = None
    if residual:
        o = x + r.standard_normal((2000, 24)).astype(np.float32)
    if np.isnan(threshold):
        want = jq.scalar_quantize(jnp.asarray(x), quantile)
        got = tq.scalar_quantize(torch.from_numpy(x), quantile)
    else:
        want = jq.scalar_quantize_noise_shaped(
            jnp.asarray(x), threshold, quantile,
            None if o is None else jnp.asarray(o))
        got = tq.scalar_quantize_noise_shaped(
            torch.from_numpy(x), threshold, quantile,
            None if o is None else torch.from_numpy(o))
        # Noise shaping moved some rows off round-to-nearest.
        assert (got.data.numpy() != tq.scalar_quantize(
            torch.from_numpy(x), quantile).data.numpy()).any()
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_allclose(got.inverse_multipliers.numpy(),
                               np.asarray(want.inverse_multipliers),
                               rtol=1e-6)
    np.testing.assert_allclose(got.sq_norms.numpy(),
                               np.asarray(want.sq_norms), rtol=1e-6)


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(3)
    c = r.standard_normal((64, 32))
    db = c[r.integers(0, 64, 3000)] + 0.25 * r.standard_normal((3000, 32))
    q = c[r.integers(0, 64, 300)] + 0.25 * r.standard_normal((300, 32))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return db.astype(np.float32), q.astype(np.float32)


# kind -> (reorder quantize, residual, noise-shaping threshold, tree)
NAN = float("nan")
KINDS = {"f32": ("float32", True, NAN, True),
         "bf16": ("bfloat16", True, NAN, True),
         "int8_residual": ("int8", True, NAN, True),
         "int8": ("int8", False, NAN, True),
         "int8_noise_shaped": ("int8", False, 0.2, True),
         "brute_force_int8": ("int8", True, 0.2, False)}


def _config(pkg, db, measure, kind):
    quantize, residual, thr, tree = KINDS[kind]
    kw = {} if pkg is scann_tpu else {"device": "cpu"}
    b = pkg.builder(db, 10, measure, **kw)
    if tree:
        b = b.tree(num_leaves=16, num_leaves_to_search=4,
                   training_sample_size=3000).score_brute_force("int8")
    else:
        b = b.score_brute_force("bfloat16")
    c = b.reorder(30, quantize=quantize,
                  anisotropic_quantization_threshold=thr).create_config()
    return dataclasses.replace(c, reordering=dataclasses.replace(
        c.reordering, residual=residual))


def _search(s, q, defaults):
    """The config's defaults (4 leaves, 30 candidates reordered), or 6
    leaves and 50 candidates."""
    if defaults:
        return s.search_batched(q[:64])
    return s.search_batched(q[:64], leaves_to_search=6,
                            pre_reorder_num_neighbors=50)


def _check_layout(s, kind):
    rh = s.reorder_helper
    quantize, residual, _, tree = KINDS[kind]
    assert (rh._leaf is not None) == (quantize == "int8" and residual
                                      and tree)
    assert (rh._inv_mult is not None) == (quantize == "int8"
                                          and rh._leaf is None)
    if tree:
        assert s._sq_mode


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jax_built_index_searches_alike(data, measure, kind, tmp_path):
    db, q = data
    scann_tpu.create_searcher(db, _config(scann_tpu, db, measure, kind)
                              ).serialize(str(tmp_path))
    js = scann_tpu.load_searcher(str(tmp_path))
    ts = scann_torch.load_searcher(str(tmp_path), device="cpu")
    _check_layout(ts, kind)
    assert_same(_search(js, q, True), _search(ts, q, True), measure, q[:64],
                db)


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_built_index_searches_alike(data, measure, kind, tmp_path):
    db, q = data
    ts = scann_torch.create_searcher(
        db, _config(scann_torch, db, measure, kind), "cpu")
    _check_layout(ts, kind)
    ts.serialize(str(tmp_path))
    js = scann_tpu.load_searcher(str(tmp_path))
    assert_same(_search(ts, q, False), _search(js, q, False), measure,
                q[:64], db)


def _recall(idx, truth):
    return np.mean([len(set(idx[i]) & set(truth[i])) / truth.shape[1]
                    for i in range(len(truth))])


def test_build_recall_matches_the_jax_build(data):
    db, q = data
    truth = np.argsort(-(q @ db.T), axis=1)[:, :10]
    recalls = [_recall(pkg.create_searcher(
        db, _config(pkg, db, "dot_product", "f32"), *dev).search_batched(
            q, leaves_to_search=6)[0], truth)
        for pkg, dev in ((scann_tpu, ()), (scann_torch, ("cpu",)))]
    assert abs(recalls[0] - recalls[1]) <= 0.01, recalls
