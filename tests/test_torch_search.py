"""Search and build parity of the whole slice against scann_tpu.

Search, without build noise: scann_tpu builds a tree-SQ index and
serializes it; scann_torch.load_searcher(..., device="cpu") loads the same
arrays, and on the same queries the top-10 ids agree on >= 99.9% of entries
and the distances within rtol 1e-4 (the bar between the JAX package's own
interpret-mode and XLA paths).  A squared-L2 distance is computed as
||q||^2 - 2 q.x + ||x||^2, so its rounding scales with those terms (~1
each for the unit vectors here) rather than with the distance: there the
1e-4 is relative to |d| + ||q||^2 + ||x||^2.  Covered: dot product and
squared L2, the invert and invert_small plans, the dense fallback (full
scan and a MAX_PLAN_WORK overflow) and a restrict allowlist.

Build, statistically: the port's own k-means draws differ from
jax.random's, so a port-built index is held to the JAX-built index's
recall@10 on the same data (within 0.02); scann_tpu loads the port's saved
index and returns the port's results."""

import numpy as np
import pytest
import torch

import scann_torch
import scann_tpu
from scann_torch.ops import pruned_scan as tps
from scann_tpu.ops import pruned_scan as jps
import torch_threads  # noqa: F401  (torch threads per xdist worker)

torch.backends.cuda.matmul.allow_tf32 = False

ID_AGREE, DIST_RTOL = 0.999, 1e-4


def _clustered(n=10000, d=32, nq=128, seed=3):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((64, d)).astype(np.float32)
    db = centers[r.integers(0, 64, n)] + 0.25 * r.standard_normal((n, d))
    q = centers[r.integers(0, 64, nq)] + 0.25 * r.standard_normal((nq, d))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return db.astype(np.float32), q.astype(np.float32)


def _tree(b):
    return (b.tree(num_leaves=32, num_leaves_to_search=6,
                   training_sample_size=5000)
            .score_brute_force(quantize="int8"))


@pytest.fixture(scope="module")
def data():
    return _clustered()


@pytest.fixture(scope="module", params=["dot_product", "squared_l2"])
def pair(request, data, tmp_path_factory):
    """(JAX searcher, port searcher loaded from its serialized index)."""
    db, _ = data
    js = _tree(scann_tpu.builder(db, 10, request.param)).build()
    path = str(tmp_path_factory.mktemp("jax_index"))
    js.serialize(path)
    return js, scann_torch.load_searcher(path, device="cpu"), request.param


def _assert_same(want, got, measure="dot_product"):
    (wi, wd), (gi, gd) = want, got
    assert gi.shape == wi.shape and gi.dtype == np.int32
    assert np.mean(gi == wi) >= ID_AGREE, np.mean(gi == wi)
    same = (gi == wi) & (wi >= 0)
    terms = 2.0 if measure == "squared_l2" else 0.0   # unit q and x
    err = np.abs(gd[same] - wd[same])
    assert np.all(err <= DIST_RTOL * (np.abs(wd[same]) + terms) + 1e-6), \
        err.max()
    np.testing.assert_array_equal(np.isnan(gd), np.isnan(wd))


@pytest.mark.parametrize("nq,leaves", [(128, 6), (16, 4), (3, "all")])
def test_search_parity(pair, data, nq, leaves):
    """(128, 6): invert plan; (16, 4): invert_small (B*L <= 128);
    (3, all leaves): full scan through the dense path."""
    js, ts, measure = pair
    _, q = data
    if leaves == "all":
        leaves = js.part_cfg.num_leaves
        assert ts.part_cfg.num_leaves == leaves
    _assert_same(js.search_batched(q[:nq], leaves_to_search=leaves),
                 ts.search_batched(q[:nq], leaves_to_search=leaves), measure)


def test_search_parity_plan_overflow_and_k(pair, data, monkeypatch):
    """A plan over MAX_PLAN_WORK takes the dense masked scan in both."""
    js, ts, measure = pair
    _, q = data
    monkeypatch.setattr(jps, "MAX_PLAN_WORK", 0)
    monkeypatch.setattr(tps, "MAX_PLAN_WORK", 0)
    js._compiled = {}
    _assert_same(js.search_batched(q, leaves_to_search=5,
                                   final_num_neighbors=7),
                 ts.search_batched(q, leaves_to_search=5,
                                   final_num_neighbors=7), measure)
    js._compiled = {}


def test_search_parity_restrict(pair, data):
    js, ts, measure = pair
    db, q = data
    allow = np.zeros(len(db), bool)
    allow[::3] = True
    want = js.search_batched(q, leaves_to_search=6, restrict_allowlist=allow)
    got = ts.search_batched(q, leaves_to_search=6, restrict_allowlist=allow)
    _assert_same(want, got, measure)
    live = got[0][got[0] >= 0]
    assert live.size and np.all(live % 3 == 0)
    i1, d1 = ts.search(q[0], leaves_to_search=6, restrict_allowlist=allow)
    np.testing.assert_array_equal(i1, got[0][0])


def _recall(idx, truth):
    return np.mean([len(set(idx[i]) & set(truth[i])) / truth.shape[1]
                    for i in range(len(truth))])


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_build_parity_and_cross_load(data, measure, tmp_path):
    db, q = data
    sim = q @ db.T if measure == "dot_product" else -(
        (q ** 2).sum(1)[:, None] - 2 * q @ db.T + (db ** 2).sum(1)[None])
    truth = np.argsort(-sim, axis=1)[:, :10]
    js = _tree(scann_tpu.builder(db, 10, measure)).build()
    ts = _tree(scann_torch.builder(db, 10, measure, device="cpu")).build()
    assert ts.slot_rows.dtype == torch.int8
    assert ts._layout.dpid.dtype == ts._layout.tile_start.dtype == torch.int32
    for leaves in (2, 6):
        rj = _recall(js.search_batched(q, leaves_to_search=leaves)[0], truth)
        got = ts.search_batched(q, leaves_to_search=leaves)
        rt = _recall(got[0], truth)
        assert abs(rt - rj) <= 0.02, (leaves, rt, rj)
    ts.serialize(str(tmp_path))
    back = scann_tpu.load_searcher(str(tmp_path))
    assert back._sq_mode
    _assert_same(got, back.search_batched(q, leaves_to_search=6), measure)


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_brute_force_parity_both_ways(data, measure, tmp_path):
    db, q = data
    js = scann_tpu.builder(db, 10, measure).score_brute_force().build()
    ts = scann_torch.builder(db, 10, measure,
                             device="cpu").score_brute_force().build()
    want = js.search_batched(q)
    _assert_same(want, ts.search_batched(q), measure)
    js.serialize(str(tmp_path / "jax"))
    _assert_same(want, scann_torch.load_searcher(
        str(tmp_path / "jax"), device="cpu").search_batched(q), measure)
    ts.serialize(str(tmp_path / "port"))
    _assert_same(want, scann_tpu.load_searcher(
        str(tmp_path / "port")).search_batched(q), measure)
