"""Per-query search parameters, crowding and pre-tokenized leaves in the
port against scann_tpu.

Pieces: sort_results, crowding_rank, crowding_filter and
crowding_filter_multi on candidate lists with exact ties, repeated
attributes and INVALID entries (equal arrays).

Search: scann_tpu builds an index (tree-AH with an exact reorder under dot
product and squared L2, tree-SQ with a reorder under cosine) and
serializes it; the port loads it and each search parameter gives the JAX
searcher's results on >= 99.9% of entries, distances within 1e-4
relative: per-query final_num_neighbors and pre_reorder_num_neighbors,
pre- and post-reordering epsilons (scalar and per query, converted to
similarity units per measure), pre_tokenized_leaves with -1 padding (the
pruned path and a plan over MAX_PLAN_WORK), pre- and post-reorder
crowding over one and two attribute dimensions, and a batch split over
the pruned dispatch cap with per-query arrays sliced beside their
queries.  Each result is also checked by rule (per-query k, epsilon cuts,
attribute caps).  The JAX package's ValueErrors are the port's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scann_torch
import scann_tpu
from scann_torch.models import base as tbase
from scann_torch.ops import pruned_scan as tps
from scann_torch.ops import topk as ttopk
from scann_tpu.models import base as jbase
from scann_tpu.ops import pruned_scan as jps
from scann_tpu.ops import topk as jtopk
from test_torch_tree_ah import _assert_same, _clustered, _flush_fault_rows

torch.backends.cuda.matmul.allow_tf32 = False


def _lists(seed, q=48, k=30, num_attrs=4):
    r = np.random.default_rng(seed)
    vals = r.integers(0, 8, (q, k)).astype(np.float32) / 8.0
    idx = r.integers(0, 500, (q, k)).astype(np.int32)
    idx[r.random((q, k)) < 0.1] = -1
    vals[idx < 0] = -np.inf
    attrs = r.integers(0, num_attrs, (q, k, 2)).astype(np.int32)
    return vals, idx, attrs


@pytest.mark.parametrize("seed", [0, 1])
def test_crowding_functions(seed):
    vals, idx, attrs = _lists(seed)
    jv, ji, ja = (jnp.asarray(a) for a in (vals, idx, attrs))
    tv, ti, ta = (torch.as_tensor(a) for a in (vals, idx, attrs))
    for want, got in (
            (jtopk.sort_results(jv, ji), ttopk.sort_results(tv, ti)),
            ((jtopk.crowding_rank(jv, ji, ja[..., 0]),),
             (ttopk.crowding_rank(tv, ti, ta[..., 0]),)),
            (jtopk.crowding_filter(jv, ji, ja[..., 0], 2),
             ttopk.crowding_filter(tv, ti, ta[..., 0], 2)),
            (jtopk.crowding_filter_multi(jv, ji, ja, (2, 3)),
             ttopk.crowding_filter_multi(tv, ti, ta, (2, 3)))):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    v, i = ttopk.crowding_filter(tv, ti, ta[..., 0], 2)
    for row_i, row_a in zip(i.numpy(), attrs[..., 0]):
        kept = row_a[row_i >= 0]
        assert np.bincount(kept, minlength=4).max() <= 2


# name -> (measure, engine).  The epsilons and pre-tokenized leaves run on
# all three; the other parameters do not depend on the measure and run on
# one index of each engine (or one index).
INDEXES = {"dot": ("dot_product", "tree_ah"),
           "l2": ("squared_l2", "tree_ah"),
           "cosine": ("cosine", "tree_sq")}


@pytest.fixture(scope="module")
def data():
    db, q = _clustered(n=4000, nq=200, topics=200, seed=9)
    # Off the unit sphere, so squared-L2 and cosine rank differently.
    db = db * np.random.default_rng(0).uniform(0.5, 1.5, (len(db), 1))
    return db.astype(np.float32), q


@pytest.fixture(scope="module")
def indexes(data, tmp_path_factory):
    """name -> (JAX searcher, port searcher loaded from its files,
    measure, crowding attributes), each built once for the module."""
    db, _ = data
    built = {}

    def get(name):
        if name not in built:
            measure, engine = INDEXES[name]
            b = scann_tpu.builder(db, 10, measure).tree(
                num_leaves=32, num_leaves_to_search=6,
                training_sample_size=4000)
            if engine == "tree_ah":
                b = b.score_ah(2, anisotropic_quantization_threshold=0.2,
                               training_sample_size=4000)
            else:
                b = b.score_brute_force("int8")
            js = b.reorder(25).build()
            path = str(tmp_path_factory.mktemp("jax_params_index"))
            js.serialize(path)
            ts = scann_torch.load_searcher(path, device="cpu")
            attrs = np.stack([np.arange(len(db)) % 7,
                              np.arange(len(db)) % 3], 1)
            js.set_crowding(attrs)
            ts.set_crowding(attrs)
            built[name] = (js, ts, measure, attrs)
        return built[name]

    return get


def _leaves(ts, q, measure, count):
    """The tokenizer's own top leaves of each query."""
    if measure == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return ts.partitioner.tokenize_queries(torch.as_tensor(q), count)[
        0].numpy()


def _both(js, ts, q, **kw):
    return js.search_batched(q, **kw), ts.search_batched(q, **kw)


def _held(pair, q, count=None, **kw):
    js, ts, measure, _ = pair
    want, got = _both(js, ts, q, **kw)
    _assert_same(want, got, "squared_l2" if measure == "squared_l2"
                 else "dot_product", count=count)
    return got


def _flush_free(pair, q):
    """Mask of the rows held in full: crowding reaches past the top 10
    into the 25 candidates, where the JAX package's CPU fault (a score of
    exactly 0 flushed to slot 0 of its group, tests/test_torch_tree_ah.py)
    shows; rows with its signature and nothing else are set aside, and
    their share is bounded."""
    js, ts, _, _ = pair
    if type(ts).__name__ != "TreeAHSearcher":
        return None
    cand = []
    for s in (js, ts):
        rh, s.reorder_helper = s.reorder_helper, None
        s._compiled = {}
        try:
            cand.append(s.search_batched(q, final_num_neighbors=25)[0])
        finally:
            s.reorder_helper = rh
            s._compiled = {}
    fault = _flush_fault_rows(ts, *cand)
    assert fault.mean() <= 0.02, fault.mean()
    return np.broadcast_to(~fault[:, None], (len(q), 10))


@pytest.mark.parametrize("name", ["dot", "cosine"])
def test_per_query_k_and_k_pre(indexes, name, data):
    pair = indexes(name)
    _, q = data
    r = np.random.default_rng(1)
    ks = r.integers(1, 11, len(q)).astype(np.int32)
    idx, dist = _held(pair, q, final_num_neighbors=ks)
    assert idx.shape[1] == 10
    for i, ki in enumerate(ks):
        assert (idx[i, :ki] >= 0).all() and (idx[i, ki:] == -1).all()
        assert np.isnan(dist[i, ki:]).all()
    pres = np.where(np.arange(len(q)) % 2 == 0, 1, 25).astype(np.int32)
    idx, _ = _held(pair, q, pre_reorder_num_neighbors=pres)
    _, ts, _, _ = pair
    one = ts.search_batched(q, pre_reorder_num_neighbors=1)[0]
    full = ts.search_batched(q, pre_reorder_num_neighbors=25)[0]
    np.testing.assert_array_equal(idx[::2], one[::2])
    np.testing.assert_array_equal(idx[1::2], full[1::2])
    # Both arrays at once: k_pre is floored at each query's k.
    _held(pair, q, final_num_neighbors=ks, pre_reorder_num_neighbors=pres)


@pytest.mark.parametrize("name", sorted(INDEXES))
def test_epsilons(indexes, name, data):
    pair = indexes(name)
    js, ts, measure, _ = pair
    _, q = data
    idx0, dist0 = ts.search_batched(q)
    # Midway between each query's third and fourth results (a cut at a
    # result's own distance would hang on its last bit).
    eps = (dist0[:, 2] + dist0[:, 3]) / 2
    idx, dist = _held(pair, q, post_reordering_epsilon=eps)
    for i in range(len(q)):
        keep = idx[i] >= 0
        assert keep.sum() >= 3
        if measure == "dot_product":
            assert (dist[i][keep] >= eps[i]).all()
        else:
            assert (dist[i][keep] <= eps[i]).all()
    _held(pair, q, post_reordering_epsilon=float(np.median(eps)))
    # Pre-reordering epsilon: loose keeps everything, strict drops it all,
    # a per-query middle cut is held against the JAX package.
    loose, strict = (-1e9, 1e9) if measure == "dot_product" else (1e9, -1.0)
    np.testing.assert_array_equal(
        ts.search_batched(q, pre_reordering_epsilon=loose)[0], idx0)
    assert (ts.search_batched(q, pre_reordering_epsilon=strict)[0]
            == -1).all()
    _held(pair, q, pre_reordering_epsilon=eps)


@pytest.mark.parametrize("path", ["pruned", "overflow"])
@pytest.mark.parametrize("name", ["dot", "l2", "cosine"])
def test_pre_tokenized_leaves(indexes, name, data, path, monkeypatch):
    pair = indexes(name)
    js, ts, measure, _ = pair
    _, q = data
    if path == "overflow":
        # The JAX package reads MAX_PLAN_WORK when it traces: its programs
        # are traced again under the patch, and after it.
        monkeypatch.setattr(jps, "MAX_PLAN_WORK", 0)
        monkeypatch.setattr(tps, "MAX_PLAN_WORK", 0)
        monkeypatch.setattr(js, "_compiled", {})
    pt = _leaves(ts, q, measure, 6)
    got = _held(pair, q, pre_tokenized_leaves=pt)
    # The tokenizer's own leaves give the plain search's results.
    np.testing.assert_array_equal(got[0], ts.search_batched(
        q, leaves_to_search=6)[0])
    # -1 pads a query's list: a row with fewer leaves.  Leaf 0 stays off
    # the padded rows (the JAX dense scan writes a padded entry's mask
    # over leaf 0, the port scatters it past the last leaf).
    r = np.random.default_rng(3)
    drop = r.random(pt.shape) < 0.35
    drop[:, 0] = False
    drop &= ~(pt == 0).any(1, keepdims=True)
    pt = np.where(drop, -1, pt)
    got = _held(pair, q, pre_tokenized_leaves=pt)
    assert (got[0] >= 0).any(1).all()


@pytest.mark.parametrize("name", ["dot", "cosine"])
def test_crowding_before_and_after_reorder(indexes, name, data):
    pair = indexes(name)
    js, ts, measure, attrs = pair
    _, q = data
    held = _flush_free(pair, q)
    for kw in (dict(per_crowding_attribute_num_neighbors=2),
               dict(per_crowding_attribute_num_neighbors=(2, 4)),
               dict(per_crowding_attribute_pre_reordering_num_neighbors=3),
               dict(per_crowding_attribute_num_neighbors=1,
                    per_crowding_attribute_pre_reordering_num_neighbors=(2,
                                                                         5))):
        idx, _ = _held(pair, q, count=held, **kw)
        post = kw.get("per_crowding_attribute_num_neighbors")
        if post is None:
            continue
        post = (post, post) if np.isscalar(post) else post
        for row in idx:
            a = attrs[row[row >= 0]]
            for dim in range(2):
                assert np.bincount(a[:, dim]).max() <= post[dim]
    # A cap of 1 before the reorder leaves at most one candidate per
    # attribute of the first dimension.
    idx, _ = ts.search_batched(
        q, per_crowding_attribute_pre_reordering_num_neighbors=(1, 100))
    assert ((idx >= 0).sum(1) <= 7).all()


@pytest.mark.parametrize("name", ["l2"])
def test_batch_over_dispatch_cap(indexes, name, data, monkeypatch):
    """Sub-batches of 48 queries: each per-query array is sliced with its
    queries."""
    pair = indexes(name)
    js, ts, measure, _ = pair
    _, q = data
    monkeypatch.setattr(jbase, "pruned_dispatch_cap", lambda leaves: 48)
    monkeypatch.setattr(tbase, "pruned_dispatch_cap", lambda leaves: 48)
    r = np.random.default_rng(4)
    n = len(q)
    pt = _leaves(ts, q, measure, 5)
    eps_base = ts.search_batched(q)[1]
    kw = dict(final_num_neighbors=r.integers(3, 11, n).astype(np.int32),
              pre_reorder_num_neighbors=r.integers(10, 26, n).astype(
                  np.int32),
              post_reordering_epsilon=(eps_base[:, 6] + eps_base[:, 7]) / 2,
              pre_reordering_epsilon=(eps_base[:, 9] - 0.5
                                      if measure == "dot_product"
                                      else eps_base[:, 9] + 0.5),
              pre_tokenized_leaves=pt,
              per_crowding_attribute_num_neighbors=3)
    got = _held(pair, q, **kw)
    monkeypatch.setattr(tbase, "pruned_dispatch_cap", lambda leaves: n)
    np.testing.assert_array_equal(ts.search_batched(q, **kw)[0], got[0])


@pytest.mark.parametrize("name", ["dot"])
def test_value_errors(indexes, name, data):
    pair = indexes(name)
    js, ts, measure, _ = pair
    db, q = data
    bad = [dict(final_num_neighbors=np.ones(3, np.int32)),
           dict(pre_reorder_num_neighbors=np.ones((len(q), 2), np.int32)),
           dict(per_crowding_attribute_num_neighbors=(1, 2, 3)),
           dict(per_crowding_attribute_pre_reordering_num_neighbors=(1,)),
           dict(pre_tokenized_leaves=np.zeros((3, 2), np.int32)),
           dict(pre_tokenized_leaves=np.full((len(q), 2), 32, np.int32)),
           dict(pre_tokenized_leaves=np.zeros((len(q), 33), np.int32)),
           dict(pre_tokenized_leaves=np.zeros((len(q), 2), np.int32)),
           dict(restrict_allowlist=np.ones(7, bool))]
    for kw in bad:
        for s in (js, ts):
            with pytest.raises(ValueError):
                s.search_batched(q, **kw)
    # Two -1 entries are not a repeated leaf.
    pt = np.full((len(q), 3), -1, np.int32)
    pt[:, 0] = 1
    _held(pair, q, pre_tokenized_leaves=pt)
    for s in (js, ts):
        with pytest.raises(ValueError):
            s.set_crowding(np.zeros(5, np.int32))


def test_crowding_and_pre_tokenized_need_their_setup(data):
    db, q = data
    for pkg, kw in ((scann_tpu, {}), (scann_torch, dict(device="cpu"))):
        s = pkg.builder(db[:500], 10, "dot_product",
                        **kw).score_brute_force().build()
        with pytest.raises(ValueError, match="set_crowding"):
            s.search_batched(q, per_crowding_attribute_num_neighbors=2)
        with pytest.raises(ValueError, match="set_crowding"):
            s.search_batched(
                q, per_crowding_attribute_pre_reordering_num_neighbors=2)
        with pytest.raises(ValueError, match="partitioned"):
            s.search_batched(q, pre_tokenized_leaves=np.zeros((len(q), 1),
                                                              np.int32))
    # Brute force crowds its final results, one limit per dimension.
    ts = scann_torch.builder(db, 20, "dot_product",
                             device="cpu").score_brute_force().build()
    js = scann_tpu.builder(db, 20, "dot_product").score_brute_force().build()
    attrs = np.stack([np.arange(len(db)) % 5, np.arange(len(db)) % 3], 1)
    ts.set_crowding(attrs)
    js.set_crowding(attrs)
    want, got = _both(js, ts, q, per_crowding_attribute_num_neighbors=(3, 4))
    _assert_same(want, got)


@pytest.mark.parametrize("name", ["cosine"])
def test_crowding_survives_serialization_reload(indexes, name, data,
                                                tmp_path):
    """Crowding attributes belong to the searcher object, as in the JAX
    package: a reloaded index asks for them again."""
    pair = indexes(name)
    js, ts, measure, attrs = pair
    _, q = data
    ts.serialize(str(tmp_path))
    again = scann_torch.load_searcher(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="set_crowding"):
        again.search_batched(q, per_crowding_attribute_num_neighbors=2)
    again.set_crowding(attrs)
    np.testing.assert_array_equal(
        again.search_batched(q, per_crowding_attribute_num_neighbors=2)[0],
        ts.search_batched(q, per_crowding_attribute_num_neighbors=2)[0])
    assert dataclasses.asdict(again.config) == dataclasses.asdict(ts.config)


@pytest.mark.parametrize("name", ["dot", "cosine"])
def test_pre_tokenized_padding_keeps_leaf_zero(indexes, name, data,
                                               monkeypatch):
    """Rows that name leaf 0 and pad with -1 search the same leaves as
    with the padding left out, on the pruned path and on the dense scan
    (the JAX package's dense scan lets a padded entry's mask overwrite
    leaf 0's: ROADMAP section 3)."""
    pair = indexes(name)
    js, ts, measure, _ = pair
    _, q = data
    pt = _leaves(ts, q, measure, 4)
    pt[:, 1:] = np.where(pt[:, 1:] == 0, -1, pt[:, 1:])
    pt[:, 0] = 0
    padded = np.concatenate([pt, np.full((len(q), 2), -1, np.int32)], 1)
    pruned = ts.search_batched(q, pre_tokenized_leaves=padded)
    np.testing.assert_array_equal(
        pruned[0], ts.search_batched(q, pre_tokenized_leaves=pt)[0])
    monkeypatch.setattr(tps, "MAX_PLAN_WORK", 0)
    dense = ts.search_batched(q, pre_tokenized_leaves=padded)
    np.testing.assert_array_equal(
        dense[0], ts.search_batched(q, pre_tokenized_leaves=pt)[0])
    # Restricted to leaf 0's rows, every query still finds them.
    leaf0 = ts.datapoint_to_token[:, 0] == 0
    idx, _ = ts.search_batched(q, pre_tokenized_leaves=padded,
                               restrict_allowlist=leaf0)
    assert (idx[:, 0] >= 0).all() and leaf0[idx[idx >= 0]].all()
