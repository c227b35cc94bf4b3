"""Deterministic parts of the tree-SQ build against scann_tpu, given the
same centers and tokens: database tokenization, oversized-leaf splitting,
partition capping, and the residual int8 encode + tile-major layout
(rows, scales, bias planes, leaf/dpid tables) of a whole index.

Tolerances: ids and int8 codes equal; float32 within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scann_tpu
from scann_torch import config as tcfg
from scann_torch.models import tree_x as ttx
from scann_torch.partitioning import kmeans_tree as tkt
from scann_tpu.partitioning import kmeans_tree as jkt
import torch_threads  # noqa: F401  (torch threads per xdist worker)

torch.backends.cuda.matmul.allow_tf32 = False


def _clusters(n=4000, d=24, k=8, seed=0, spread=0.3):
    r = np.random.default_rng(seed)
    c = r.standard_normal((k, d)).astype(np.float32) * 3
    x = (c[r.integers(0, k, n)]
         + spread * r.standard_normal((n, d))).astype(np.float32)
    return x, c


def test_tokenize_database():
    x, c = _clusters()
    jp = jkt.KMeansTreePartitioner(centers=jnp.asarray(c), centers_int8=None,
                                   centers_inv_mult=None,
                                   query_distance="dot_product")
    tp = tkt.KMeansTreePartitioner(centers=torch.from_numpy(c),
                                   query_distance="dot_product")
    want = np.asarray(jp.tokenize_database(x))
    got = tp.tokenize_database(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    q = x[:50]
    jw, js = jp.tokenize_queries(jnp.asarray(q), 3)
    tw, ts = tp.tokenize_queries(torch.from_numpy(q), 3)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize("cap", [300, 400])
def test_split_oversized(cap):
    # Each leaf holds two well-separated halves, so the 2-means split has
    # no near-tie members whose side could hang on float rounding.
    x, c = _clusters(seed=cap, spread=0.05)
    r = np.random.default_rng(cap)
    halves = 1.5 * r.standard_normal((len(c), x.shape[1])).astype(np.float32)
    tokens = np.argmin(((x[:, None] - c[None]) ** 2).sum(-1), axis=1)
    x = x + np.where(r.random(len(x)) < 0.5, 1.0, -1.0).astype(
        np.float32)[:, None] * halves[tokens]
    jt, jc = jkt.split_oversized(jnp.asarray(x), tokens, c, cap)
    tt, tc = tkt.split_oversized(torch.from_numpy(x), tokens, c, cap)
    assert len(jc) > len(c)                      # splits happened
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)
    assert np.bincount(tt).max() <= cap


def test_cap_partition_sizes():
    x, c = _clusters(seed=3)
    tokens = np.argmin(((x[:, None] - c[None]) ** 2).sum(-1), axis=1)
    cap = int(np.percentile(np.bincount(tokens), 60))
    want = jkt.cap_partition_sizes(x, tokens, c, cap)
    got = tkt.cap_partition_sizes(torch.from_numpy(x), tokens, c, cap)
    assert (want != tokens).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_residual_encode_and_layout(measure):
    """The port's encode on the JAX index's own tokens and centers gives
    the JAX index's arrays."""
    x, _ = _clusters(n=6000, d=20, k=12, seed=5)
    js = (scann_tpu.builder(x, 10, measure)
          .tree(num_leaves=12, num_leaves_to_search=3,
                training_sample_size=3000)
          .score_brute_force(quantize="int8").build())
    tokens = np.asarray(js.datapoint_to_token)[:, 0]
    ts = object.__new__(ttx.TreeXSearcher)
    ts.config = tcfg.ScannConfig.from_json(js.config.to_json())
    ts.device = torch.device("cpu")
    ts.dims = x.shape[1]
    ts.measure = measure
    ts.partitioner = tkt.KMeansTreePartitioner(
        centers=torch.from_numpy(np.array(js.partitioner.centers)),
        query_distance=measure)
    assert ts._build_sq(torch.from_numpy(x), tokens)
    np.testing.assert_array_equal(ts.slot_rows.numpy(),
                                  np.asarray(js.slot_rows))
    lay = ts._layout
    for name, got in (("slot_leaf", ts.slot_leaf), ("slot_dpid", lay.dpid),
                      ("_p_tile_start", lay.tile_start),
                      ("_p_ntiles", lay.ntiles)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(js, name)), name)
    for name, got in (("slot_scale", ts.slot_scale), ("_bias2", lay.bias)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    if measure == "squared_l2":
        np.testing.assert_allclose(ts._sq_norms.numpy(),
                                   np.asarray(js._sq_norms), rtol=1e-5)
    for name, got in (("_p_max_ntiles", lay.max_ntiles),
                      ("_p_num_tiles", lay.num_tiles),
                      ("_num_slots", ts._num_slots), ("_chunk", ts._chunk)):
        assert got == getattr(js, name), name
