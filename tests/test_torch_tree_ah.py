"""Search and build parity of the tree-AH slice against scann_tpu.

Search, without build noise: scann_tpu builds a tree-AH index and
serializes it; scann_torch.load_searcher(..., device="cpu") loads the same
arrays, and on the same queries the top-10 ids agree on >= 99.9% of
entries and the distances within rtol 1e-4 (squared L2: relative to
|d| + ||q||^2 + ||x||^2, the terms the distance is computed from).
Covered: int8 lookup (K3 path), float32 lookup and 256-center codes (K4
path), reconstruct mode (K2 path; its dense masked scan of the decoded
rows on the full scan and the overflow), dot product and squared L2, no
reorder and float32 / bfloat16 / residual-int8 reorder, the invert and
invert_small plans, the dense LUT16 scan (full scan and a MAX_PLAN_WORK
overflow), a restrict allowlist and the 16-survivor width.  The fused
scan, the fused merge and the searcher without a tree are held in
tests/test_torch_tree_ah_recon.py, on an index large enough for them.
Reconstruct-mode scores are f32 sums that tie rarely, so the same 99.9%
bar holds them with room.  The pre-reorder budget stays under 32: from there
on the JAX merge selects with approx_max_k, whose choice among the exactly
tied int8-LUT scores at the cut is not lax.top_k's lower-index-first, and
the port's selection is exact.  One known difference stays inside the
0.1% except under a restrict: a score of exactly 0 packs to a denormal,
which XLA's CPU backend flushes to zero, so the JAX package reports slot
0 of the group for it while the port keeps the right slot (ROADMAP
section 3).  The restrict case sets aside only the rows that carry that
signature (_flush_fault_rows) and bounds their share.

Build, statistically, in tests/test_torch_tree_ah_build.py (split off so
that pytest-xdist's ``--dist loadfile`` runs it on another worker): the
port's k-means draws differ from jax.random's, so a port-built index is
held to the JAX-built index's recall@10 (within 0.02)."""

import dataclasses

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


def _clustered(n=6000, d=32, nq=200, topics=300, noise=0.5, seed=3):
    """Many loose topics: a leaf then holds far more rows than a query's
    candidates, as in a real corpus (a few tight clusters would make the
    per-group survivor capacity, not the index, decide recall)."""
    r = np.random.default_rng(seed)
    centers = r.standard_normal((topics, d)).astype(np.float32)
    db = centers[r.integers(0, topics, n)] + noise * r.standard_normal((n, d))
    q = centers[r.integers(0, topics, nq)] + noise * r.standard_normal(
        (nq, d))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return db.astype(np.float32), q.astype(np.float32)


# name -> (measure, lookup_type, hash_type, dims_per_block, reorder quantize)
CASES = {
    "dot_int8_f32": ("dot_product", "int8", "lut16", 2, "float32"),
    "dot_int8_none": ("dot_product", "int8", "lut16", 2, None),
    "l2_int8_bf16": ("squared_l2", "int8", "lut16", 2, "bfloat16"),
    "dot_float_int8": ("dot_product", "float32", "lut16", 2, "int8"),
    "l2_float_none": ("squared_l2", "float32", "lut16", 2, None),
    "dot_lut256_f32": ("dot_product", "int8", "lut256", 4, "float32"),
    "dot_recon_f32": ("dot_product", "reconstruct", "lut16", 2, "float32"),
    "l2_recon_none": ("squared_l2", "reconstruct", "lut16", 2, None),
}


def _config(builder_fn, case, reorder_k=30, tree=True, **kw):
    measure, lookup, hash_type, dpb, reorder = CASES[case]
    db = kw.pop("db")
    b = builder_fn(db, 10, measure, **kw)
    if tree:
        b = b.tree(num_leaves=32, num_leaves_to_search=6,
                   training_sample_size=4000)
    b = b.score_ah(dpb, anisotropic_quantization_threshold=0.2,
                   hash_type=hash_type, training_sample_size=4000)
    if reorder is not None:
        b = b.reorder(reorder_k, quantize=reorder)
    config = b.create_config()
    return dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type=lookup))


@pytest.fixture(scope="module")
def data():
    return _clustered()


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, data, tmp_path_factory):
    """(JAX searcher, port searcher loaded from its serialized index)."""
    db, _ = data
    js = scann_tpu.create_searcher(
        db, _config(scann_tpu.builder, request.param, db=db))
    path = str(tmp_path_factory.mktemp("jax_ah_index"))
    js.serialize(path)
    ts = scann_torch.load_searcher(path, device="cpu")
    return js, ts, CASES[request.param][0]


def _assert_same(want, got, measure="dot_product", count=None,
                 id_agree=ID_AGREE):
    """Each id the JAX package returns is held by membership in the port's
    top-k of that query (one differing candidate shifts every later
    position of its row), and its distance against that entry's; on the
    rows whose id sets agree, the ids are also held position by position
    (two ids whose distances tie within the tolerance may swap).
    ``count``: optional mask of the JAX entries that are held."""
    (wi, wd), (gi, gd) = want, got
    assert gi.shape == wi.shape and gi.dtype == np.int32
    match = wi[:, :, None] == gi[:, None, :]
    found = match.any(-1)
    held = np.ones_like(found) if count is None else count
    assert found[held].mean() >= id_agree, found[held].mean()
    terms = 2.0 if measure == "squared_l2" else 0.0   # unit q and x
    rows = (found & held).all(1)
    in_place = (wi == gi) | (
        np.abs(gd - wd) <= DIST_RTOL * (np.abs(wd) + terms) + 1e-6)
    assert rows.any() and in_place[rows].mean() >= id_agree, \
        in_place[rows].mean()
    gd_of = np.take_along_axis(gd, match.argmax(-1), axis=1)
    same = found & held & (wi >= 0)
    err = np.abs(gd_of[same] - wd[same])
    assert np.all(err <= DIST_RTOL * (np.abs(wd[same]) + terms) + 1e-6), \
        err.max()
    if count is None:
        np.testing.assert_array_equal(np.isnan(gd), np.isnan(wd))


@pytest.mark.parametrize("nq,leaves", [(200, 6), (16, 4), (40, "all")])
def test_search_parity(pair, data, nq, leaves):
    """(200, 6): invert plan; (16, 4): invert_small (B*L <= 128);
    (40, all leaves): full scan through the dense LUT16 path."""
    js, ts, measure = pair
    _, q = data
    if leaves == "all":
        leaves = js.part_cfg.num_leaves
        assert ts.part_cfg.num_leaves == leaves
    _assert_same(js.search_batched(q[:nq], leaves_to_search=leaves),
                 ts.search_batched(q[:nq], leaves_to_search=leaves), measure)


def test_search_parity_pre_reorder_and_k(pair, data):
    js, ts, measure = pair
    _, q = data
    kw = dict(leaves_to_search=5, final_num_neighbors=7,
              pre_reorder_num_neighbors=25)
    _assert_same(js.search_batched(q, **kw), ts.search_batched(q, **kw),
                 measure)


def test_search_parity_plan_overflow(pair, data, monkeypatch):
    """A plan over MAX_PLAN_WORK takes the dense masked scan in both."""
    js, ts, measure = pair
    _, q = data
    monkeypatch.setattr(jps, "MAX_PLAN_WORK", 0)
    monkeypatch.setattr(tps, "MAX_PLAN_WORK", 0)
    js._compiled = {}
    _assert_same(js.search_batched(q[:64], leaves_to_search=5),
                 ts.search_batched(q[:64], leaves_to_search=5), measure)
    # The dense layout was materialized: device codes, or decoded rows.
    assert (ts._recon_rows if ts._recon_mode else ts.index.codes) is not None
    js._compiled = {}


def _candidates(searcher, q, allow, k):
    """The pre-reorder candidates: the search with its reorder stage off."""
    rh, searcher.reorder_helper = searcher.reorder_helper, None
    searcher._compiled = {}
    try:
        return searcher.search_batched(
            q, leaves_to_search=6, restrict_allowlist=allow,
            final_num_neighbors=k)[0]
    finally:
        searcher.reorder_helper = rh
        searcher._compiled = {}


def _flush_fault_rows(ts, jax_cand, port_cand):
    """Rows whose JAX candidates show the denormal flush (module note) and
    nothing else: every id the JAX package holds and the port does not,
    or holds twice, sits at identity 0 of a 32-slot group (first tile of its leaf, first
    slot of the group), what a flushed survivor unpacks to, and the port
    holds in its place another slot of that same group of that leaf.  A
    disagreement of any other kind leaves its row held."""
    dpid = ts._p_dpid.numpy()
    live = np.nonzero(dpid >= 0)[0]
    pos = np.full(int(dpid.max()) + 1, -1, np.int64)
    pos[dpid[live]] = live
    ntiles = ts._p_ntiles.numpy()
    tile_leaf = np.repeat(np.arange(len(ntiles)), ntiles)
    tile0 = ts._p_tile_start.numpy()

    def identity(i):
        tile, slot = divmod(pos[i], tps.TILE)
        leaf = tile_leaf[tile]
        return leaf, slot // tps.SUBP, tile - tile0[leaf], slot % tps.SUBP

    fault = np.zeros(len(jax_cand), bool)
    for r, (jrow, prow) in enumerate(zip(jax_cand, port_cand)):
        ids, times = np.unique(jrow[jrow >= 0], return_counts=True)
        jax_only = (set(ids) - set(prow)) | set(ids[times > 1])
        port_groups = {identity(i)[:2]
                       for i in set(prow[prow >= 0]) - set(jrow)}
        fault[r] = bool(jax_only) and all(
            identity(i)[2:] == (0, 0) and identity(i)[:2] in port_groups
            for i in jax_only)
    return fault


def test_search_parity_restrict_and_wide_survivors(pair, data):
    js, ts, measure = pair
    db, q = data
    allow = np.zeros(len(db), bool)
    allow[::3] = True
    want = js.search_batched(q, leaves_to_search=6, restrict_allowlist=allow)
    got = ts.search_batched(q, leaves_to_search=6, restrict_allowlist=allow)
    # The denormal flush makes the JAX package name slot 0 of a group,
    # allowed or not, in place of a candidate that scores exactly 0.  Rows
    # whose candidates carry that signature are not held against the port;
    # under squared L2 the best scores lie around zero and it strikes
    # often (35 of the 200 rows with int8 lookup), under dot product
    # hardly ever (at most 1 row).  A growing exclusion fails.
    k_cand = 10 if js.reorder_helper is None else 30
    port_cand = _candidates(ts, q, allow, k_cand)
    fault = _flush_fault_rows(ts, _candidates(js, q, allow, k_cand),
                              port_cand)
    assert fault.mean() <= (0.18 if measure == "squared_l2" else 0.01)
    assert allow[port_cand[port_cand >= 0]].all()
    held = np.broadcast_to(~fault[:, None], want[0].shape)
    _assert_same(want, got, measure, count=held)
    live = got[0][got[0] >= 0]
    assert live.size and np.all(live % 3 == 0)
    js._kpg_override = ts._kpg_override = 16
    js._compiled = {}
    try:
        _assert_same(js.search_batched(q, leaves_to_search=6),
                     ts.search_batched(q, leaves_to_search=6), measure)
    finally:
        js._kpg_override = ts._kpg_override = None
        js._compiled = {}


def _recall(idx, truth):
    return np.mean([len(set(idx[i]) & set(truth[i])) / truth.shape[1]
                    for i in range(len(truth))])
