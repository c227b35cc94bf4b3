"""Brute-force searchers of the port against scann_tpu on the CPU: float32,
int8 and bfloat16 rows under dot product, squared L2 and cosine, and
float32 L1.

Search, on the same serialized index, both directions: scann_tpu builds and
serializes, and the index loaded by scann_tpu and by scann_torch return the
same results; the port builds and serializes, and scann_tpu loads it and
returns the port's results.  Bar: >= 99.9% of the top-10 ids found in
the other package's top 10 of the same query (two rows whose scores tie
to the last bit may trade places); distances within 1e-4 relative, where a squared L2 distance is held
relative to |d| + ||q||^2 + ||x||^2 (it is computed from those terms, so
its rounding scales with them).  bf16 rows need no wider bar: bf16 x bf16
products are exact in f32 in both packages, only the summation order
differs.  The rows are clustered with norms spread from 0.5 to 2, so
cosine's normalization changes the ranking.

Build: brute force has no training, so a port-built index is the JAX-built
one, int8 codes and multipliers included; its recall@10 against the
float32 truth equals the JAX-built index's within 1 pt."""

import numpy as np
import pytest

import scann_torch
import scann_tpu

ID_AGREE, DIST_RTOL = 0.999, 1e-4
KINDS = [(m, q) for m in ("dot_product", "squared_l2", "cosine")
         for q in ("float32", "int8", "bfloat16")] + [("l1", "float32")]


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(11)
    c = r.standard_normal((48, 32))
    db = c[r.integers(0, 48, 3000)] + 0.3 * r.standard_normal((3000, 32))
    db *= r.uniform(0.5, 2.0, (3000, 1))
    q = c[r.integers(0, 48, 64)] + 0.3 * r.standard_normal((64, 32))
    return db.astype(np.float32), q.astype(np.float32)


def assert_same(want, got, measure, q, db):
    """The parity bar of the module docstring."""
    (wi, wd), (gi, gd) = want, got
    assert gi.shape == wi.shape and gi.dtype == np.int32
    found = (wi[:, :, None] == gi[:, None, :]).any(-1)
    assert found.mean() >= ID_AGREE, found.mean()
    same = (gi == wi) & (wi >= 0)
    scale = np.abs(wd)
    if measure == "squared_l2":
        scale = scale + (q ** 2).sum(1)[:, None] + (
            db[np.maximum(wi, 0)] ** 2).sum(-1)
    err = np.abs(gd[same] - wd[same])
    assert np.all(err <= DIST_RTOL * scale[same] + 1e-6), err.max()
    np.testing.assert_array_equal(np.isnan(gd), np.isnan(wd))


def _builder(pkg, db, measure, quantize):
    kw = {} if pkg is scann_tpu else {"device": "cpu"}
    return pkg.builder(db, 10, measure, **kw).score_brute_force(quantize)


@pytest.mark.parametrize("measure,quantize", KINDS)
def test_jax_built_index_searches_alike(data, measure, quantize, tmp_path):
    db, q = data
    _builder(scann_tpu, db, measure, quantize).build().serialize(
        str(tmp_path))
    js = scann_tpu.load_searcher(str(tmp_path))
    ts = scann_torch.load_searcher(str(tmp_path), device="cpu")
    assert ts.quantize_mode == quantize
    assert_same(js.search_batched(q), ts.search_batched(q), measure, q, db)


@pytest.mark.parametrize("measure,quantize", KINDS)
def test_port_built_index_searches_alike(data, measure, quantize, tmp_path):
    db, q = data
    ts = _builder(scann_torch, db, measure, quantize).build()
    got = ts.search_batched(q)
    ts.serialize(str(tmp_path))
    assert_same(got, scann_tpu.load_searcher(str(tmp_path)).search_batched(
        q), measure, q, db)


def _recall(idx, truth):
    return np.mean([len(set(idx[i]) & set(truth[i])) / truth.shape[1]
                    for i in range(len(truth))])


@pytest.mark.parametrize("quantize", ["int8", "bfloat16"])
def test_build_matches_the_jax_build(data, quantize):
    db, q = data
    truth = np.argsort(-(q @ db.T), axis=1)[:, :10]
    js = _builder(scann_tpu, db, "dot_product", quantize).build()
    ts = _builder(scann_torch, db, "dot_product", quantize).build()
    if quantize == "int8":
        np.testing.assert_array_equal(ts._db.numpy(), np.asarray(js._db))
        np.testing.assert_allclose(ts._inv_mult.numpy(),
                                   np.asarray(js._inv_mult), rtol=1e-6)
    rj = _recall(js.search_batched(q)[0], truth)
    rt = _recall(ts.search_batched(q)[0], truth)
    assert abs(rt - rj) <= 0.01 and rt > 0.9, (rt, rj)


def test_chunked_scan_and_l1_cost(data, monkeypatch):
    """A score block over _MAX_SCORES takes the chunked scan with a running
    top-k merge, chunked d times finer under L1, and returns the one-block
    results."""
    from scann_torch.models import brute_force
    db, q = data
    for measure, quantize in (("l1", "float32"), ("squared_l2", "int8")):
        ts = _builder(scann_torch, db, measure, quantize).build()
        want = ts.search_batched(q)
        monkeypatch.setattr(brute_force, "_MAX_SCORES", 64 * 700)
        calls = []
        sim = brute_force.dist_ops.similarity
        monkeypatch.setattr(brute_force.dist_ops, "similarity",
                            lambda *a, **k: (calls.append(a[1].shape[0]),
                                             sim(*a, **k))[1])
        assert_same(want, ts.search_batched(q), measure, q, db)
        cost = 32 if measure == "l1" else 1
        assert calls[0] == 700 // cost and len(calls) == -(-3000 // calls[0])
        monkeypatch.undo()
