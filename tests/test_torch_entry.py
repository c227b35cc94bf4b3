"""The search entry on the CPU (models/base.py): handles of
``search_batched_async`` whose results are taken out of order equal
``search_batched``, a second ``result()`` returns the same arrays, and the
counters of the CUDA copies (``base.async_batches``,
``base.result_waits``) stay 0: the CPU path has no copy streams.  The
card's side is tests/test_torch_cuda_entry_copies.py."""

import numpy as np
import pytest

import scann_torch
from scann_torch.models import base
import torch_threads  # noqa: F401  (torch threads per xdist worker)

KINDS = ("tree_ah", "tree_ah_soar", "tree_x", "brute_force", "split")


def _data(n=2000, nq=40, d=16, seed=5):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((24, d))
    db = c[rng.integers(0, 24, n)] + 0.3 * rng.standard_normal((n, d))
    q = c[rng.integers(0, 24, 3 * nq)] + 0.3 * rng.standard_normal(
        (3 * nq, d))
    return db.astype(np.float32), q.astype(np.float32).reshape(3, nq, d)


def _build(kind, db):
    b = scann_torch.builder(db, 10, "squared_l2" if kind == "tree_x"
                            else "dot_product", device="cpu")
    if kind == "brute_force":
        return b.score_brute_force().build()
    b = b.tree(num_leaves=16, num_leaves_to_search=4,
               training_sample_size=len(db),
               soar_lambda=1.5 if kind == "tree_ah_soar" else None)
    if kind == "tree_x":
        return b.score_brute_force(quantize="int8").reorder(30).build()
    return b.score_ah(2, anisotropic_quantization_threshold=0.2) \
        .reorder(30).build()


@pytest.fixture(scope="module")
def built():
    db, q = _data()
    searchers = {k: _build(k, db) for k in KINDS if k != "split"}
    searchers["split"] = searchers["tree_ah"]
    return searchers, q


def _split(kind, monkeypatch):
    if kind == "split":        # each 40-query batch: three sub-batches
        monkeypatch.setattr(base, "pruned_dispatch_cap", lambda leaves: 16)


@pytest.mark.parametrize("kind", KINDS)
def test_out_of_order_results_equal_search_batched(built, kind,
                                                   monkeypatch):
    searchers, q = built
    s = searchers[kind]
    _split(kind, monkeypatch)
    want = [s.search_batched(b) for b in q]
    pend = [s.search_batched_async(b) for b in q]
    for i in (2, 0, 1):
        idx, dist = pend[i].result()
        np.testing.assert_array_equal(idx, want[i][0])
        np.testing.assert_array_equal(dist, want[i][1])


@pytest.mark.parametrize("kind", KINDS)
def test_result_twice_returns_the_same_arrays(built, kind, monkeypatch):
    searchers, q = built
    _split(kind, monkeypatch)
    p = searchers[kind].search_batched_async(q[0])
    first = p.result()
    second = p.result()
    assert second[0] is first[0] and second[1] is first[1]


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_path_leaves_the_copy_counters_at_zero(built, kind,
                                                   monkeypatch):
    searchers, q = built
    _split(kind, monkeypatch)
    monkeypatch.setattr(base, "async_batches", 0)
    monkeypatch.setattr(base, "result_waits", 0)
    pend = [searchers[kind].search_batched_async(b) for b in q]
    for p in pend[::-1]:
        p.result()
    assert base.async_batches == 0 and base.result_waits == 0
