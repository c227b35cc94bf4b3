"""The port's public API against scann_tpu's (ROADMAP fault 3c): the
ReorderType enum in reorder / score_brute_force / upper_tree,
set_n_training_threads, Searcher.query_dims and search_batched_parallel,
the four distance functions of ops/distance.py, every top-level name of
scann_tpu, and the profiling and transfer utilities, on the CPU."""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import scann_torch
import scann_tpu
from scann_torch.ops import distance as tdist
from scann_tpu.ops import distance as jdist
import torch_threads  # noqa: F401  (torch threads per xdist worker)


def _db(n=300, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["FLOAT32", "INT8", "BFLOAT16"])
@pytest.mark.parametrize("tree", [False, True])
def test_reorder_type_configs_equal_jax(name, tree):
    db = _db()

    def make(pkg, **kw):
        rt = getattr(pkg.ReorderType, name)
        b = pkg.builder(db, 5, "dot_product", **kw)
        if tree:
            b = b.tree(num_leaves=4, num_leaves_to_search=2).upper_tree(
                2, 1, scoring_mode=rt)
        return b.score_brute_force(rt).reorder(20, quantize=rt)

    port = make(scann_torch, device="cpu")
    assert port.create_config().to_json() == \
        make(scann_tpu).create_config().to_json()
    assert scann_torch.ReorderType[name].value == \
        scann_tpu.ReorderType[name].value


def test_set_n_training_threads_returns_the_builder():
    b = scann_torch.builder(_db(), 5, "dot_product", device="cpu")
    assert b.set_n_training_threads(4) is b and b.training_threads == 4
    s = b.score_brute_force().build()
    assert s.search_batched(_db(3, seed=1))[0].shape == (3, 5)


@pytest.mark.parametrize("projection", [None, "pca", "truncate"])
def test_query_dims_and_search_batched_parallel(projection):
    db, q = _db(), _db(20, seed=1)

    def make(pkg, **kw):
        b = pkg.builder(db, 5, "dot_product", **kw)
        if projection == "pca":
            b = b.pca(8, pca_significance_threshold=None)
        elif projection == "truncate":
            b = b.truncate(8)
        return b.score_brute_force().build()

    s = make(scann_torch, device="cpu")
    assert s.query_dims == make(scann_tpu).query_dims == 16
    if projection is not None:
        assert s._index_dims == 8
    want = s.search_batched(q, final_num_neighbors=3)
    got = s.search_batched_parallel(q, final_num_neighbors=3, batch_size=7)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


_DISTANCES = ["cosine_distance", "hamming_distance", "jaccard_distance",
              "limited_inner_product_distance"]


@pytest.mark.parametrize("name", _DISTANCES)
@pytest.mark.parametrize("nonneg", [False, True])
def test_distance_functions_match_jax(name, nonneg):
    r = np.random.default_rng(3)
    q = r.standard_normal((7, 12)).astype(np.float32)
    x = r.standard_normal((30, 12)).astype(np.float32) * 3
    x[4] = 0.0                              # a zero row hits every floor
    if nonneg:
        q, x = np.abs(q), np.abs(x)
    want = np.asarray(getattr(jdist, name)(q, x))
    got = getattr(tdist, name)(torch.from_numpy(q),
                               torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if name == "hamming_distance":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_every_top_level_name_of_scann_tpu_exists():
    names = {n for n, v in vars(scann_tpu).items()
             if not n.startswith("_") and not inspect.ismodule(v)}
    missing = sorted(n for n in names if not hasattr(scann_torch, n))
    assert not missing, missing
    for n in names:
        if inspect.isfunction(getattr(scann_tpu, n)):
            assert n in scann_torch.__all__, n
    # Entry points that build or load a searcher take a device.
    for n in ("load_searcher", "searcher_from_tensors",
              "load_reference_assets", "builder_from_pbtxt",
              "searcher_from_pbtxt", "serve", "builder"):
        params = inspect.signature(getattr(scann_torch, n)).parameters
        assert params["device"].default == "cuda", n


def test_profiling_trace_and_log_phase(tmp_path, caplog):
    from scann_torch.utils import profiling
    s = scann_torch.builder(_db(), 5, "dot_product",
                            device="cpu").score_brute_force().build()
    with profiling.trace(str(tmp_path)) as prof:
        s.search_batched(_db(4, seed=2))
    events = json.load(open(os.path.join(tmp_path, profiling.TRACE_FILE)))
    assert events["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())
    import logging
    with caplog.at_level(logging.INFO, logger="scann_torch"):
        with profiling.log_phase("phase x"):
            pass
    assert "phase x took" in caplog.text


def test_transfer_to_device():
    from scann_torch.utils import transfer
    a = np.arange(12, dtype=np.int64).reshape(3, 4)
    t = transfer.to_device(a, torch.float32, "cpu")
    assert t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), a)
    assert transfer.to_device(t, torch.float32, "cpu") is t
    assert transfer.default_layout(t) is t
