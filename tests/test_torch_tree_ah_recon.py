"""Reconstruct mode on an index large enough for the fused scan, and the
non-partitioned AH searcher, against scann_tpu (helpers, cases and bars of
tests/test_torch_tree_ah.py).

On 24,000 rows (the fused scan's gate needs 4 x the reorder budget in
256-slot groups: 96 groups against 4 x 20) a JAX-built, serialized index is
loaded by the port and held on: the full scan through K5 (the JAX package
runs its Pallas kernel in interpret mode), the restricted full scan (the
group-max variant of the dense scan of the decoded rows), the pruned path
with the fused merge forced on in both packages through their environment
variables, and the same without a tree (every query a K5 scan; the LUT
modes take the dense LUT16 scan with no (query, leaf) table).  A port-built
reconstruct or non-partitioned index is held to the JAX-built one's
recall@10, and scann_tpu.load_searcher returns the port's results from the
port's files."""

import numpy as np
import pytest

import scann_torch
import scann_tpu
import test_torch_tree_ah_build as base
from test_torch_tree_ah import (CASES, _assert_same, _clustered, _config,
                                _recall, data)  # noqa: F401  (data: fixture)
import torch_threads  # noqa: F401  (torch threads per xdist worker)


@pytest.mark.parametrize("case", ["dot_recon_f32", "l2_recon_none"])
def test_build_parity_and_cross_load(data, case, tmp_path):  # noqa: F811
    """The build-parity test of tests/test_torch_tree_ah_build.py on the
    reconstruct cases (6,000 rows: the pruned path through K2's plain
    version, the full scan through the dense scan of the decoded rows)."""
    base.test_build_parity_and_cross_load(data, case, tmp_path)


BIG_REORDER = 20


@pytest.fixture(scope="module")
def big_data():
    return _clustered(n=24000, nq=128, topics=600, seed=5)


# name -> (case of CASES, with a tree)
BIG = {"dot_recon": ("dot_recon_f32", True),
       "l2_recon": ("l2_recon_none", True),
       "dot_recon_no_tree": ("dot_recon_f32", False),
       "l2_recon_no_tree": ("l2_recon_none", False),
       "dot_int8_no_tree": ("dot_int8_f32", False),
       "l2_float_no_tree": ("l2_float_none", False)}


@pytest.fixture(scope="module", params=sorted(BIG))
def big_pair(request, big_data, tmp_path_factory):
    db, _ = big_data
    case, tree = BIG[request.param]
    config = _config(scann_tpu.builder, case, reorder_k=BIG_REORDER,
                     tree=tree, db=db)
    js = scann_tpu.create_searcher(db, config)
    js._fused_interpret = True      # its Pallas K5 in interpret mode
    path = str(tmp_path_factory.mktemp("jax_big_index"))
    js.serialize(path)
    ts = scann_torch.load_searcher(path, device="cpu")
    return js, ts, CASES[case][0], tree, CASES[case][1] == "reconstruct"


def test_full_scan_parity(big_pair, big_data, monkeypatch):
    """Reconstruct mode: the fused scan (K5) in both packages, every query
    of an index without a tree included.  LUT modes without a tree: the
    dense LUT16 scan with no (query, leaf) table."""
    js, ts, measure, tree, recon = big_pair
    _, q = big_data
    from scann_torch.ops import fused_scan
    calls = []
    monkeypatch.setattr(
        fused_scan, "fused_scan_groupmax",
        lambda *a, _f=fused_scan.fused_scan_groupmax, **k: (
            calls.append(1), _f(*a, **k))[1])
    kw = dict(leaves_to_search=ts.part_cfg.num_leaves) if tree else {}
    _assert_same(js.search_batched(q, **kw), ts.search_batched(q, **kw),
                 measure)
    assert len(calls) == (1 if recon else 0)
    assert ts._pruned_available == tree
    if not tree:
        assert ts.partitioner is None and ts._default_leaves() == 0
    # A batch that is no multiple of any tile, and a single query.
    _assert_same(js.search_batched(q[:37], **kw),
                 ts.search_batched(q[:37], **kw), measure)
    np.testing.assert_array_equal(ts.search(q[3])[0] if not tree else
                                  ts.search(q[3], leaves_to_search=10 ** 6)[0],
                                  ts.search_batched(q[:8], **kw)[0][3])


def test_restricted_full_scan_parity(big_pair, big_data):
    """A restrict turns the fused scan off: the dense masked scan, which
    in reconstruct mode keeps one candidate per 256-slot group (96 groups
    >= 4 x 20 candidates here)."""
    js, ts, measure, tree, recon = big_pair
    db, q = big_data
    allow = np.zeros(len(db), bool)
    allow[::3] = True
    kw = dict(leaves_to_search=ts.part_cfg.num_leaves) if tree else {}
    got = ts.search_batched(q, restrict_allowlist=allow, **kw)
    _assert_same(js.search_batched(q, restrict_allowlist=allow, **kw), got,
                 measure)
    live = got[0][got[0] >= 0]
    assert live.size and np.all(live % 3 == 0)


def test_fused_merge_parity(big_pair, big_data, monkeypatch):
    """Both packages with their fused merge forced on (budget 20 <= 32),
    and the port's fused merge against its own stratified merge."""
    js, ts, measure, tree, recon = big_pair
    _, q = big_data
    if not tree:
        # No pruned path, so no merge: the switch changes nothing.
        off = ts.search_batched(q)
        monkeypatch.setenv("SCANN_TORCH_FUSED_MERGE", "1")
        np.testing.assert_array_equal(ts.search_batched(q)[0], off[0])
        return
    kw = dict(leaves_to_search=6)
    off = ts.search_batched(q, **kw)
    monkeypatch.setenv("SCANN_TPU_FUSED_MERGE", "1")
    monkeypatch.setenv("SCANN_TORCH_FUSED_MERGE", "1")
    js._compiled = {}
    from scann_torch.ops import pruned_scan
    calls = []
    monkeypatch.setattr(
        pruned_scan, "merge_candidates_fused",
        lambda *a, _f=pruned_scan.merge_candidates_fused, **k: (
            calls.append(1), _f(*a, **k))[1])
    try:
        on = ts.search_batched(q, **kw)
        _assert_same(js.search_batched(q, **kw), on, measure)
    finally:
        js._compiled = {}
    assert calls
    # The fused selection is exact; the stratified one keeps one candidate
    # per group of a cold leaf, so a rare entry may differ.
    found = (off[0][:, :, None] == on[0][:, None, :]).any(-1)
    assert found.mean() >= 0.99, found.mean()


@pytest.mark.parametrize("name,rows", [("dot_recon_no_tree", 24000),
                                       ("l2_recon_no_tree", 6000),
                                       ("dot_int8_no_tree", 6000)])
def test_port_built_big_index_and_cross_load(big_data, name, rows, tmp_path):
    """A port-built non-partitioned index (at 24,000 rows every query goes
    through K5; at 6,000 through the dense scans): recall within 0.03 of
    the JAX-built one, and scann_tpu.load_searcher returns the port's
    results from the port's files.  (Port-built reconstruct indexes with a
    tree: test_build_parity_and_cross_load above.)"""
    db, q = big_data
    db = db[:rows]
    case, tree = BIG[name]
    measure = CASES[case][0]
    sim = q @ db.T if measure == "dot_product" else -(
        (q ** 2).sum(1)[:, None] - 2 * q @ db.T + (db ** 2).sum(1)[None])
    truth = np.argsort(-sim, axis=1)[:, :10]
    js = scann_tpu.create_searcher(
        db, _config(scann_tpu.builder, case, reorder_k=60, tree=tree, db=db))
    ts = scann_torch.create_searcher(
        db, _config(scann_torch.builder, case, reorder_k=60, tree=tree,
                    db=db, device="cpu"), "cpu")
    for kw in ([dict(leaves_to_search=6), dict(leaves_to_search=10 ** 6)]
               if tree else [dict()]):
        rj = _recall(js.search_batched(q, **kw)[0], truth)
        rt = _recall(ts.search_batched(q, **kw)[0], truth)
        assert abs(rt - rj) <= 0.03, (kw, rt, rj)
    ts.serialize(str(tmp_path))
    back = scann_tpu.load_searcher(str(tmp_path))
    back._fused_interpret = True
    assert (back.partitioner is not None) == tree
    again = scann_torch.load_searcher(str(tmp_path), device="cpu")
    for kw in ([dict(leaves_to_search=6), dict(leaves_to_search=32)]
               if tree else [dict()]):
        got = ts.search_batched(q, **kw)
        _assert_same(got, back.search_batched(q, **kw), measure)
        np.testing.assert_array_equal(again.search_batched(q, **kw)[0],
                                      got[0])
