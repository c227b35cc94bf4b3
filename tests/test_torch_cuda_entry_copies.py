"""Card tests of the search entry's copies (``models/base._BatchCopies``;
marker ``cuda``, they skip without a card).  On a CUDA device a batch's
upload and its result copy run on copy streams of their own, from and into
pinned host memory, each ordered by an event against the batch's own work:

* result(i) waits for batch i only, not for what was enqueued after it
  (a 200 ms device sleep and batch i+1);
* answers with three batches in flight, taken out of order, are bit-equal
  to blocking searches one at a time: tree-AH (glove-shaped, K3), tree-SQ
  (SIFT-shaped, K1), tree-AH with SOAR, and a split batch;
* a result's arrays are unchanged after ten more batches;
* the dispatch makes no host-synchronising call;
* ``base.async_batches`` counts a dispatch (a sub-batch of a split batch),
  ``base.result_waits`` a result whose copy had not finished.

On a machine with a card (no JAX needed)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_entry_copies.py
"""

import time

import numpy as np
import pytest
import torch

import scann_torch
from scann_torch.models import base
import torch_threads  # noqa: F401  (torch threads per xdist worker)

pytestmark = pytest.mark.cuda

SLEEP_MS = 200.0
SPLIT_CAP = 128          # a 300-query batch: three sub-batches


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(d, n=20_000, nq=300, seed=0):
    """Clustered rows, and four batches of queries from the same topics."""
    r = np.random.default_rng(seed)
    c = r.standard_normal((64, d))
    db = c[r.integers(0, 64, n)] + 0.3 * r.standard_normal((n, d))
    q = c[r.integers(0, 64, 4 * nq)] + 0.3 * r.standard_normal((4 * nq, d))
    return db.astype(np.float32), q.astype(np.float32).reshape(4, nq, d)


def _build(kind):
    if kind == "tree_sq":        # SIFT-shaped: tree-SQ through K1
        db, q = _data(128)
        return (scann_torch.builder(db, 10, "squared_l2").set_seed(1)
                .tree(num_leaves=64, num_leaves_to_search=8,
                      training_sample_size=len(db))
                .score_brute_force(quantize="int8").reorder(40).build()), q
    db, q = _data(100)           # glove-shaped: unit rows, K3
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=2, keepdims=True)
    soar = kind == "tree_ah_soar"
    return (scann_torch.builder(db, 10, "dot_product").set_seed(1)
            .tree(num_leaves=64, num_leaves_to_search=8,
                  training_sample_size=len(db),
                  soar_lambda=1.5 if soar else None,
                  overretrieve_factor=2.0 if soar else None)
            .score_ah(2, anisotropic_quantization_threshold=0.2,
                      training_sample_size=len(db))
            .reorder(150 if soar else 100).build()), q


@pytest.fixture(scope="module")
def searchers(cuda):
    out = {}
    for kind in ("tree_ah", "tree_sq", "tree_ah_soar"):
        s, q = _build(kind)
        # The lazy layouts, the kernel libraries and two batches' pinned
        # buffers, before anything is timed.
        pend = [s.search_batched_async(b) for b in q[:2]]
        for p in pend:
            p.result()
        out[kind] = (s, q)
    torch.cuda.synchronize()
    return out


def _sleep_cycles(ms):
    """Cycles of ``torch.cuda._sleep`` that take about ``ms`` on this card."""
    n = 10_000_000
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(n)
    b.record()
    b.synchronize()
    return int(n * ms / a.elapsed_time(b))


def _equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_result_waits_for_its_own_batch_only(searchers):
    s, q = searchers["tree_ah"]
    cycles = _sleep_cycles(SLEEP_MS)
    torch.cuda.synchronize()
    first = s.search_batched_async(q[0])
    torch.cuda._sleep(cycles)
    second = s.search_batched_async(q[1])
    t = time.perf_counter()
    got = first.result()
    took_ms = (time.perf_counter() - t) * 1e3
    still_busy = not torch.cuda.current_stream().query()
    second.result()
    assert took_ms < 0.25 * SLEEP_MS, took_ms
    assert still_busy
    _equal(got, s.search_batched(q[0]))


@pytest.mark.parametrize("kind", ["tree_ah", "tree_sq", "tree_ah_soar",
                                  "split"])
def test_out_of_order_results_equal_blocking(searchers, kind, monkeypatch):
    s, q = searchers["tree_ah" if kind == "split" else kind]
    if kind == "split":
        monkeypatch.setattr(base, "pruned_dispatch_cap",
                            lambda leaves: SPLIT_CAP)
    want = [s.search_batched(b) for b in q[:3]]
    pend = [s.search_batched_async(b) for b in q[:3]]
    for i in (2, 0, 1):
        _equal(pend[i].result(), want[i])


def test_results_alias_no_later_batch(searchers):
    s, q = searchers["tree_ah"]
    got = s.search_batched_async(q[0]).result()
    kept = (got[0].copy(), got[1].copy())
    pend = []
    for i in range(10):
        pend.append(s.search_batched_async(q[1 + i % 3]))
        if len(pend) == 2:
            pend.pop(0).result()
    pend.pop(0).result()
    torch.cuda.synchronize()
    _equal(got, kept)


@pytest.mark.parametrize("kind", ["tree_ah", "tree_sq", "tree_ah_soar"])
def test_dispatch_never_waits_on_the_host(searchers, kind):
    s, q = searchers[kind]
    want = s.search_batched(q[2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pend = s.search_batched_async(q[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _equal(pend.result(), want)


def test_counters(searchers, monkeypatch):
    s, q = searchers["tree_ah"]
    before = base.async_batches
    s.search_batched_async(q[0]).result()
    assert base.async_batches == before + 1
    monkeypatch.setattr(base, "pruned_dispatch_cap",
                        lambda leaves: SPLIT_CAP)
    s.search_batched_async(q[0]).result()
    assert base.async_batches == before + 1 + -(-len(q[0]) // SPLIT_CAP)
    monkeypatch.undo()
    # The second batch's copy waits behind the sleep: its result waits.
    cycles = _sleep_cycles(SLEEP_MS)
    torch.cuda.synchronize()
    waits = base.result_waits
    first = s.search_batched_async(q[0])
    torch.cuda._sleep(cycles)
    second = s.search_batched_async(q[1])
    first.result()
    mid = base.result_waits
    second.result()
    assert base.result_waits == mid + 1 and mid <= waits + 1
