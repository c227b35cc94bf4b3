"""Mutation (docids, upsert / update / delete) of the port against
scann_tpu, slot for slot.

A JAX-built index with docids is serialized and the port loads it; both
packages then apply one scripted sequence: upsert new rows, update
existing docids with other rows (one docid twice in the call), delete,
re-insert deleted docids, and upsert more rows than there are free slots,
so the layout grows (and, in reconstruct mode, the mean is recomputed).
After it the slot arrays (codes, leaf, dpid), the token map, the reorder
rows and the mutation mirror are equal, and the searches agree at the bars
of tests/test_torch_tree_ah.py (ids >= 99.9%, distances within 1e-4; the
budget stays at 30, under the JAX merge's approx_max_k).  Covered: int8
lookup (the K3 path), reconstruct mode under squared L2 with a tree (the
K2 path and the full scan of the decoded rows, whose mean stays that of
the last rebuild until the layout grows) and without one (every query a
full scan; its decoded rows are written in place), SOAR (two slots a row)
with residual-int8 reordering, and brute force over float32, int8,
bfloat16 and uint8 rows."""

import numpy as np
import pytest
import torch

import scann_torch
import scann_tpu
from test_torch_tree_ah import _assert_same, _clustered, _config
import torch_threads  # noqa: F401  (torch threads per xdist worker)

N, N_EXTRA = 4000, 1600


@pytest.fixture(scope="module")
def data():
    db, q = _clustered(n=N)
    extra, _ = _clustered(n=N_EXTRA, seed=9)
    return db, q, extra


def ids_of(result):
    """Docid results (ints here, None at invalid slots) as an int32 array."""
    idx, dist = result
    return (np.array([[-1 if x is None else x for x in row] for row in idx],
                     np.int32), dist)


def script(s, extra, free):
    """The scripted sequence; ``free`` is the index's free slot count, so
    the last upsert overflows it."""
    s.upsert(list(range(N, N + 200)), extra[:200])
    # Updates, with docid 12 twice: its row is the last one given.
    s.upsert(list(range(10, 30)) + [12], extra[200:221])
    s.delete(list(range(100, 200)))
    s.upsert([100, 101], extra[230:232])
    grow = free + 150
    s.upsert(list(range(N + 200, N + 200 + grow)), extra[300:300 + grow])


def _soar_config(builder_fn, db, **kw):
    return (builder_fn(db, 10, "dot_product", **kw)
            .tree(num_leaves=32, num_leaves_to_search=6,
                  training_sample_size=4000, soar_lambda=1.5)
            .score_ah(2, anisotropic_quantization_threshold=0.2,
                      training_sample_size=4000)
            .reorder(30, quantize="int8").create_config())


# name -> (config maker, measure, with a tree)
TREE_AH = {
    "int8": (lambda db: _config(scann_tpu.builder, "dot_int8_f32", db=db),
             "dot_product", True),
    "recon_l2": (lambda db: _config(scann_tpu.builder, "l2_recon_none",
                                    db=db), "squared_l2", True),
    "recon_no_tree": (lambda db: _config(scann_tpu.builder, "dot_recon_f32",
                                         tree=False, db=db),
                      "dot_product", False),
    "soar_int8_reorder": (lambda db: _soar_config(scann_tpu.builder, db),
                          "dot_product", True),
}


def _equal_state(js, ts):
    for key in ("codes", "leaf", "dpid"):
        np.testing.assert_array_equal(ts._host[key],
                                      np.asarray(js._host[key]), key)
    np.testing.assert_array_equal(ts.index.slot_dpid.numpy(),
                                  ts._host["dpid"])
    np.testing.assert_array_equal(ts.index.slot_leaf.numpy(),
                                  ts._host["leaf"])
    np.testing.assert_array_equal(ts.datapoint_to_token,
                                  np.asarray(js.datapoint_to_token))
    assert ts._num_slots == js._num_slots
    assert ts.docids == js.docids and ts.n_points == js.n_points
    np.testing.assert_array_equal(ts._mut.vectors, js._mut.vectors)
    np.testing.assert_array_equal(ts._mut.alive, js._mut.alive)
    assert ts._mut.docid_to_id == js._mut.docid_to_id
    rt, rj = ts.reorder_helper, js.reorder_helper
    if rt is not None:
        for key in ("_db", "_inv_mult", "_leaf", "_row_scale"):
            got, want = getattr(rt, key), getattr(rj, key)
            assert (got is None) == (want is None), key
            if got is not None:
                np.testing.assert_array_equal(
                    got.float().numpy(), np.asarray(want, np.float32), key)
        if rt._sq_norms is not None:
            np.testing.assert_allclose(rt._sq_norms.numpy(),
                                       np.asarray(rj._sq_norms), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("name", sorted(TREE_AH))
def test_tree_ah_mutation_parity(data, name, tmp_path):
    db, q, extra = data
    make, measure, tree = TREE_AH[name]
    js = scann_tpu.create_searcher(db, make(db), docids=list(range(N)))
    js._fused_interpret = True
    js.serialize(str(tmp_path))
    ts = scann_torch.load_searcher(str(tmp_path), device="cpu")
    full = dict(leaves_to_search=10 ** 6) if tree else {}
    # A full scan first, so the lazily built device layouts (LUT codes,
    # decoded rows) exist and take the mutations in place.
    _assert_same(ids_of(js.search_batched(q[:40], **full)),
                 ids_of(ts.search_batched(q[:40], **full)), measure)
    free = int((ts._host["dpid"] < 0).sum())
    assert free == int((np.asarray(js._host["dpid"]) < 0).sum())
    mean0 = None if ts._recon_mean is None else ts._recon_mean.clone()
    ts.upsert([N + 5000], extra[-1:])
    js.upsert([N + 5000], extra[-1:])
    if mean0 is not None:
        # The mean of the last rebuild: an upsert into free slots keeps it.
        np.testing.assert_array_equal(ts._recon_mean.numpy(), mean0.numpy())
    slots0 = len(ts._host["dpid"])
    script(js, extra, free)
    script(ts, extra, free)
    assert len(ts._host["dpid"]) > slots0          # the layout grew
    assert len(ts._host["dpid"]) % ts._chunk == 0
    _equal_state(js, ts)
    stats = ts.get_health_stats()
    assert stats == pytest.approx(js.get_health_stats(), rel=1e-6)
    if ts.part_cfg is not None:
        # Every token column counts: twice the rows under SOAR.
        assert stats["sum_partition_sizes"] == \
            (ts.datapoint_to_token >= 0).sum()
    if ts.part_cfg is not None and ts.part_cfg.soar is not None:
        assert (ts._slot_table[N:N + 200] >= 0).all()   # two slots a row
    if mean0 is not None:
        assert not np.array_equal(ts._recon_mean.numpy(), mean0.numpy())
        np.testing.assert_allclose(ts._recon_mean.numpy(),
                                   np.asarray(js._recon_mean), atol=1e-6)
    if not tree:
        np.testing.assert_array_equal(ts._recon_bias.numpy(),
                                      np.asarray(js._recon_bias))
    points = [dict(leaves_to_search=6), full] if tree else [{}]
    for kw in points:
        want = ids_of(js.search_batched(q, **kw))
        got = ids_of(ts.search_batched(q, **kw))
        _assert_same(want, got, measure)
        gone = np.isin(got[0], np.arange(100, 200)[2:])
        assert not gone.any()               # deleted docids never return
    if tree:
        assert ts._pruned_built             # the pruned layout was rebuilt


# name -> (builder chain, measure, dtype of the database)
BRUTE_FORCE = {
    "float32_int8_reorder": (lambda b: b.score_brute_force().reorder(
        20, quantize="int8"), "dot_product", np.float32),
    "int8": (lambda b: b.score_brute_force("int8"), "squared_l2",
             np.float32),
    "bfloat16_reorder": (lambda b: b.score_brute_force("bfloat16").reorder(
        20, quantize="bfloat16"), "squared_l2", np.float32),
    "uint8": (lambda b: b.score_brute_force(), "squared_l2", np.uint8),
}


@pytest.mark.parametrize("name", sorted(BRUTE_FORCE))
def test_brute_force_mutation_parity(data, name):
    db, q, extra = data
    chain, measure, dtype = BRUTE_FORCE[name]
    if dtype == np.uint8:
        db, extra = (np.clip(np.rint(a * 60 + 128), 0, 255).astype(np.uint8)
                     for a in (db, extra))
        q = q * 60 + 128
    js = chain(scann_tpu.builder(db, 10, measure)).build(
        docids=list(range(N)))
    ts = chain(scann_torch.builder(db, 10, measure, device="cpu")).build(
        docids=list(range(N)))
    if dtype == np.uint8:
        assert ts._db.dtype == torch.uint8       # rows stay 1 B a dimension
    for s in (js, ts):
        # Free capacity of 0: the first upsert grows the rows by a fifth.
        script(s, extra.astype(np.float32), 0)
    for key in ("_db", "_valid", "_sq_norms", "_inv_mult"):
        got, want = getattr(ts, key), getattr(js, key)
        assert (got is None) == (want is None), key
        if got is not None:
            # Squared norms are float32 sums in each package's order.
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want, np.float32),
                rtol=1e-6 if key == "_sq_norms" else 0, atol=0,
                err_msg=key)
    if ts.reorder_helper is not None:
        for key in ("_db", "_sq_norms"):
            got = getattr(ts.reorder_helper, key)
            if got is not None:
                np.testing.assert_allclose(
                    got.float().numpy(),
                    np.asarray(getattr(js.reorder_helper, key), np.float32),
                    rtol=1e-6, atol=1e-6)
    # Docid 12 was given twice in one call: the last row wins.
    row = extra[220].astype(np.float32)
    np.testing.assert_array_equal(ts._mut.vectors[12], row)
    if ts.quantize_mode is None or ts.quantize_mode == "float32":
        want12 = np.clip(np.rint(row), 0, 255) if dtype == np.uint8 else row
        np.testing.assert_array_equal(ts._db[12].float().numpy(), want12)
    # The squared-L2 bar is relative to |d| + ||q||^2 + ||x||^2, which
    # _assert_same takes as |d| + 2 (unit rows): uint8 rows rescale to it.
    scale = 1.0 if dtype != np.uint8 else 0.5 * (
        (q ** 2).sum(1).max() + (db.astype(np.float32) ** 2).sum(1).max())

    def held(**kw):
        (wi, wd), (gi, gd) = (ids_of(s.search_batched(q, **kw))
                              for s in (js, ts))
        _assert_same((wi, wd / scale), (gi, gd / scale), measure)
        return gi

    held()
    allow = np.zeros(ts.n_points, bool)
    allow[::3] = True
    got = held(restrict_allowlist=allow)
    # Re-inserted docids took new ids: map the docids back to row ids.
    rows = [ts._mut.docid_to_id[d] for d in got[got >= 0]]
    assert len(rows) and allow[rows].all()


def test_results_carry_docids(data):
    """Docids in the results, None past the rows that exist, on the direct
    path and through the sub-batched combine; the DenseDataset's docids
    serve too."""
    from scann_torch.data import dataset
    db, q, _ = data
    names = [f"d{i}" for i in range(6)]
    s = scann_torch.builder(dataset.DenseDataset(db[:6], docids=names), 8,
                            "dot_product", device="cpu"
                            ).score_brute_force().build()
    idx, dist = s.search_batched(db[:2])
    assert idx[0][0] == "d0" and idx[1][0] == "d1"
    assert idx[0][6:] == [None, None] and np.isnan(dist[:, 6:]).all()
    assert s.search(db[3])[0][0] == "d3"
    jdx = scann_tpu.builder(db[:6], 8, "dot_product").score_brute_force(
    ).build(docids=names).search_batched(db[:2])[0]
    assert jdx == idx
    ts = (scann_torch.builder(db, 10, "dot_product", device="cpu")
          .tree(num_leaves=32, num_leaves_to_search=4,
                training_sample_size=4000)
          .score_ah(2).build(docids=[f"r{i}" for i in range(N)]))
    from scann_torch.models import base
    cap = base.pruned_dispatch_cap(4)
    base_cap, base._PRUNED_MAX_BATCH = base._PRUNED_MAX_BATCH, 64
    try:
        split = ts.search_batched(q[:150])[0]
    finally:
        base._PRUNED_MAX_BATCH = base_cap
    assert base.pruned_dispatch_cap(4) == cap
    whole = ts.search_batched(q[:150])[0]
    assert isinstance(split, list) and split == whole
    assert all(isinstance(x, str) for row in whole for x in row)


def test_port_built_mutated_index_loads_in_the_jax_package(data, tmp_path):
    """Port -> scann_tpu: files and the tensors dict carry docids and the
    mutation state; the JAX package searches the mutated index alike and
    takes the next upsert where the port left off.  scann_tpu -> port
    through the tensors dict."""
    db, q, extra = data
    config = _config(scann_torch.builder, "dot_int8_f32", db=db,
                     device="cpu")
    ts = scann_torch.create_searcher(db, config, "cpu",
                                     docids=list(range(N)))
    script(ts, extra, int((ts._host["dpid"] < 0).sum()))
    ts.serialize(str(tmp_path))
    js = scann_tpu.load_searcher(str(tmp_path))
    want = ids_of(ts.search_batched(q, leaves_to_search=6))
    _assert_same(want, ids_of(js.search_batched(q, leaves_to_search=6)))
    assert js.docids == ts.docids
    np.testing.assert_array_equal(js._mut.alive, ts._mut.alive)
    assert js._mut.mutations_since_rebuild == \
        ts._mut.mutations_since_rebuild
    back = scann_tpu.searcher_from_tensors(scann_torch.searcher_to_tensors(ts))
    _assert_same(want, ids_of(back.search_batched(q, leaves_to_search=6)))
    # A reference fault: the JAX loader restores the alive mask read-only,
    # so a reloaded JAX index cannot update or delete until an upsert of a
    # new docid has replaced the array (ROADMAP section 3).  The port's
    # loaded index takes both.
    with pytest.raises(ValueError, match="read-only"):
        scann_tpu.load_searcher(str(tmp_path)).delete([7])
    # A reloaded index rebuilds its free-slot list in slot order (the
    # running one's order is gone), so the port's reload is held against
    # the JAX package's.
    tl = scann_torch.load_searcher(str(tmp_path), device="cpu")
    for s in (js, tl):
        s.upsert([N + 9000], extra[-1:])
        s.upsert([7], extra[-2:-1])
        s.delete([8])
    _equal_state(js, tl)
    again = scann_torch.searcher_from_tensors(
        scann_tpu.searcher_to_tensors(js), "cpu")
    _equal_state(js, again)
    assert again._leaf_deletions.shape == (again.partitioner.num_leaves,)
