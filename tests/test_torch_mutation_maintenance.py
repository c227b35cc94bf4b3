"""Incremental maintenance, rebalance, the threshold rule, health stats and
the refusals of mutation, in the port against scann_tpu.

Merging is deterministic (a leaf's center is dropped and its rows are
re-tokenized against the rest), so after the same deletes and
``incremental_maintenance(max_splits=0)`` both packages hold the same
centers, tokens, slots and search results.  Splitting and ``rebalance``
draw from each package's generator (a 2-means with k-means++, a full
retrain), so they are held statistically: a leaf more per split, only the
split leaf's rows move, and recall@10 over the live rows within 1 pt of
the JAX package on the same sequence.  Also here: the JAX loader's missing
``_leaf_deletions`` (its maintenance fails on a reloaded index; the
port's works on the same files), and the refusals, which the port makes
before it changes any state."""

import numpy as np
import pytest

import scann_torch
import scann_tpu
from scann_torch import mutation as tmut
from scann_torch.utils import health
from scann_tpu import mutation as jmut
from test_torch_mutation import N, data, ids_of  # noqa: F401 (fixture)
from test_torch_tree_ah import _assert_same
import torch_threads  # noqa: F401  (torch threads per xdist worker)


def _tree_ah(builder_fn, db, **tree_kw):
    return (builder_fn(db, 10, "dot_product")
            .tree(num_leaves=32, num_leaves_to_search=6,
                  training_sample_size=4000, **tree_kw)
            .score_ah(2, anisotropic_quantization_threshold=0.2,
                      training_sample_size=4000)
            .reorder(30).create_config())


def _recall(s, q, leaves=6):
    """recall@10 of docid results against exact dot product over the live
    rows."""
    st = s._mut
    live = np.nonzero(st.alive)[0]
    top = live[np.argsort(-(q @ st.vectors[live].T), axis=1)[:, :10]]
    truth = np.asarray(s.docids, object)[top]
    got = s.search_batched(q, leaves_to_search=leaves)[0]
    return np.mean([len(set(g) & set(t)) / 10 for g, t in zip(got, truth)])


def _aligned(a):
    """A copy of ``a`` on a 64-byte boundary."""
    buf = np.empty(a.nbytes + 64, np.uint8)
    off = (-buf.ctypes.data) % 64
    out = buf[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def test_merge_maintenance_is_exact(data, tmp_path):  # noqa: F811
    """Also a reference fault: on the CPU, XLA may alias a 64-byte aligned
    numpy array instead of copying it, and the JAX package's merge shifts
    the host leaf table in place and then the device one, so an aliased
    device table is shifted twice.  Here it is aliased on purpose; the
    JAX host tables stay right (and the port holds to them), and the JAX
    device table is repaired from them before the searches are compared.
    The port's device tables never view its host tables."""
    import jax.numpy as jnp
    db, q, _ = data
    js = scann_tpu.create_searcher(db, _tree_ah(scann_tpu.builder, db),
                                   docids=list(range(N)))
    js.serialize(str(tmp_path))
    ts = scann_torch.load_searcher(str(tmp_path), device="cpu")
    js._host["leaf"] = _aligned(js._host["leaf"])
    js.index = js.index._replace(slot_leaf=jnp.asarray(js._host["leaf"]))
    prim = ts.datapoint_to_token[:, 0]
    counts = np.bincount(prim, minlength=ts.partitioner.num_leaves)
    a, b = np.argsort(counts, kind="stable")[:2]
    # Leaf a keeps one row (re-tokenized by the merge), leaf b none.
    gone = [int(i) for i in np.nonzero(prim == a)[0][1:]] + \
        [int(i) for i in np.nonzero(prim == b)[0]]
    nl = ts.partitioner.num_leaves
    for s in (js, ts):
        s.delete(gone)
        assert s.incremental_maintenance(max_splits=0) == 2
    assert ts.partitioner.num_leaves == nl - 2
    assert ts.part_cfg.num_leaves == nl - 2 == ts.config.partitioning.num_leaves
    np.testing.assert_array_equal(ts.partitioner.centers.numpy(),
                                  np.asarray(js.partitioner.centers))
    np.testing.assert_array_equal(ts.datapoint_to_token,
                                  np.asarray(js.datapoint_to_token))
    for key in ("codes", "leaf", "dpid"):
        np.testing.assert_array_equal(ts._host[key],
                                      np.asarray(js._host[key]), key)
    np.testing.assert_array_equal(ts.index.slot_leaf.numpy(),
                                  ts._host["leaf"])
    shifted = np.asarray(js.index.slot_leaf) != js._host["leaf"]
    assert shifted.any() and (np.asarray(js.index.slot_leaf)[shifted]
                              == js._host["leaf"][shifted] - 1).all()
    js.index = js.index._replace(slot_leaf=jnp.array(js._host["leaf"]))
    assert ts._leaf_deletions.shape == (nl - 2,)
    for leaves in (6, nl - 2):
        _assert_same(ids_of(js.search_batched(q, leaves_to_search=leaves)),
                     ids_of(ts.search_batched(q, leaves_to_search=leaves)))


@pytest.fixture(scope="module")
def online_incremental(data, tmp_path_factory):  # noqa: F811
    """A JAX-built index under online_incremental maintenance (threshold a
    fraction of 0.05), built in memory, and its files."""
    db, _, _ = data
    js = scann_tpu.create_searcher(
        db, _tree_ah(scann_tpu.builder, db, incremental_threshold=0.05,
                     incremental_mode="online_incremental"),
        docids=list(range(N)))
    path = str(tmp_path_factory.mktemp("online_incremental"))
    js.serialize(path)
    return js, path


def test_jax_loader_loses_leaf_deletions(online_incremental):
    """A reference fault: the JAX loader restores _leaf_mutations but not
    _leaf_deletions, so maintenance on a reloaded JAX index raises; the
    port restores zeros and maintains the same files."""
    _, path = online_incremental
    with pytest.raises(AttributeError, match="_leaf_deletions"):
        scann_tpu.load_searcher(path).incremental_maintenance()
    ts = scann_torch.load_searcher(path, device="cpu")
    np.testing.assert_array_equal(
        ts._leaf_deletions, np.zeros(ts.partitioner.num_leaves, np.int64))
    assert ts.incremental_maintenance() >= 0


def test_split_maintenance_statistically(data, online_incremental):  # noqa: F811
    """Skewed upserts (noisy copies of the biggest leaf's rows) past the
    threshold split that leaf in both packages: a leaf more per split, only
    the split leaves' rows move, recall within 1 pt of the JAX package;
    then deletes past the threshold merge a drained leaf away."""
    db, q, _ = data
    js, path = online_incremental
    ts = scann_torch.load_searcher(path, device="cpu")
    prim = ts.datapoint_to_token[:, 0]
    big = int(np.bincount(prim).argmax())
    members = np.nonzero(prim == big)[0]
    r = np.random.default_rng(4)
    rows = db[r.choice(members, 260)] + 0.02 * r.standard_normal(
        (260, db.shape[1])).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    before, splits = {}, []
    split_fn, maint_fn = ts._split_partition, ts.incremental_maintenance

    def maintenance(*a, **kw):
        before["tokens"] = ts.datapoint_to_token.copy()
        before["leaves"] = ts.partitioner.num_leaves
        return maint_fn(*a, **kw)

    def split(token):
        done = split_fn(token)
        splits.append((token, done))
        return done

    merges, merge_fn = [], ts._merge_partition

    def merge(token):
        merges.append(token)
        return merge_fn(token)

    ts.incremental_maintenance, ts._split_partition = maintenance, split
    ts._merge_partition = merge
    docids = list(range(N, N + 260))
    for s in (js, ts):
        s.upsert(docids, rows)               # 260 > 0.05 * 4260: maintain
        assert s._mut.mutations_since_rebuild == 0
    done = [t for t, ok in splits if ok]
    assert big in done
    nl0 = before["leaves"]
    assert ts.partitioner.num_leaves == nl0 + len(done)
    assert js.partitioner.num_leaves == nl0 + len(done)
    old, new = before["tokens"][:, 0], ts.datapoint_to_token[:, 0]
    moved = np.nonzero(old != new)[0]
    # Only the split leaves' rows are re-tokenized (against every center,
    # so a few settle in a neighbouring leaf).
    assert len(moved) and np.isin(old[moved], done).all()
    assert (new[moved] >= nl0).mean() > 0.5

    def imbalance(tokens):
        alive = ts._mut.alive[:len(tokens)]
        return health.partition_imbalance(np.bincount(
            tokens[alive, 0], minlength=ts.partitioner.num_leaves))[0]

    assert imbalance(ts.datapoint_to_token) < imbalance(before["tokens"])
    rt, rj = _recall(ts, q), _recall(js, q)
    assert abs(rt - rj) <= 0.01, (rt, rj)
    # Drain one leaf (all its rows, over the threshold): a merge.
    prim = ts.datapoint_to_token[:, 0]
    counts = np.bincount(prim[ts._mut.alive], minlength=nl0 + len(done))
    leaf = int(np.argsort(counts)[1])
    gone = [ts.docids[i] for i in np.nonzero(ts._mut.alive
                                             & (prim == leaf))[0]]
    gone += [d for d in range(1000, 1400) if d not in gone]
    for s in (js, ts):
        s.delete(gone)
    assert leaf in merges
    assert ts._mut.mutations_since_rebuild == 0
    rt, rj = _recall(ts, q), _recall(js, q)
    assert abs(rt - rj) <= 0.01, (rt, rj)


def test_rebalance_statistically(data):  # noqa: F811
    """rebalance() retrains on the live rows (tombstones dropped, ids
    renumbered) on the searcher's device; recall within 1 pt of the JAX
    package's rebalance on the same sequence."""
    db, q, extra = data
    out = []
    for pkg, kw in ((scann_tpu, {}), (scann_torch, dict(device="cpu"))):
        config = _tree_ah(lambda *a: pkg.builder(*a, **kw), db)
        s = (pkg.create_searcher(db, config, docids=list(range(N)))
             if pkg is scann_tpu else
             pkg.create_searcher(db, config, "cpu", docids=list(range(N))))
        s.upsert(list(range(N, N + 500)), extra[:500])
        s.delete(list(range(0, 600)))
        s.rebalance()
        assert s.n_points == N - 100 and s._mut.alive.all()
        assert s._mut.mutations_since_rebuild == 0
        assert s.docids == list(range(600, N + 500))
        out.append(_recall(s, q, leaves=8))
        if pkg is scann_torch:
            assert s.device.type == "cpu"
            assert s.index.slot_dpid.shape[0] >= N - 100
    assert abs(out[0] - out[1]) <= 0.01, out


def test_threshold_rule(data):  # noqa: F811
    """A float below 1.0 is a fraction of the index, anything else a
    count; past it an upsert rebalances (online) or maintains
    (online_incremental), and a delete maintains only under
    online_incremental."""
    class Cfg:
        incremental_threshold = None

    class St:
        mutations_since_rebuild = 0

    part, st = Cfg(), St()
    for thr in (None, 0.05, 0.5, 0.999, 1.0, 3, 3.0, 250):
        part.incremental_threshold = thr
        for m in (0, 1, 3, 4, 49, 50, 51, 250, 251, 600):
            st.mutations_since_rebuild = m
            for n in (10, 1000):
                assert tmut.incremental_threshold_exceeded(part, st, n) == \
                    jmut.incremental_threshold_exceeded(part, st, n)
    assert tmut.incremental_threshold_exceeded(None, st, 10) is False
    db, _, extra = data
    calls = []
    for mode in ("online", "online_incremental"):
        config = _tree_ah(lambda *a: scann_torch.builder(*a, device="cpu"),
                          db[:2000], incremental_threshold=5,
                          incremental_mode=mode)
        s = scann_torch.create_searcher(db[:2000], config, "cpu",
                                        docids=list(range(2000)))
        s.rebalance = lambda: calls.append(("rebalance", mode))
        maint = s.incremental_maintenance
        s.incremental_maintenance = lambda *a, **k: (
            calls.append(("maintenance", mode)), maint(*a, **k))[1]
        s.upsert(list(range(2000, 2005)), extra[:5])     # 5: not past 5
        s.delete([0, 1, 2])                              # 8 > 5
        s.upsert(list(range(2005, 2011)), extra[5:11])   # 6 more > 5
        expect_reset = mode == "online_incremental"
        assert (s._mut.mutations_since_rebuild == 0) == expect_reset
    assert calls == [("rebalance", "online"),
                     ("maintenance", "online_incremental"),
                     ("maintenance", "online_incremental")]


def test_refusals_change_no_state(data):  # noqa: F811
    """No docids, a length mismatch, an unknown or repeated docid in a
    delete, and Tree-X (which does not mutate, as in the JAX package) all
    raise before the searcher changes; the JAX package's Tree-X appends
    the rows first."""
    db, q, extra = data
    s = scann_torch.builder(db[:200], 10, "dot_product", device="cpu"
                            ).score_brute_force().build()
    for call in (lambda: s.upsert([1], extra[:1]), lambda: s.delete([1])):
        with pytest.raises(ValueError, match="built with docids"):
            call()
    s = scann_torch.builder(db[:200], 10, "dot_product", device="cpu"
                            ).score_brute_force().build(
                                docids=[f"d{i}" for i in range(200)])
    with pytest.raises(ValueError, match="docids must have one entry"):
        scann_torch.builder(db[:200], 10, "dot_product", device="cpu"
                            ).score_brute_force().build(docids=["a"])
    with pytest.raises(ValueError, match="mismatch"):
        s.upsert(["d1", "x"], extra[:1])
    for gone in (["d3", "nope"], ["d3", "d3"]):
        with pytest.raises(ValueError, match="unknown docid"):
            s.delete(gone)
    assert s._mut.alive.all() and len(s._mut.docid_to_id) == 200
    assert s._valid.all() and s.search(db[3])[0][0] == "d3"
    # An upsert may repeat a docid: the row is its last one.
    s.upsert(["d5", "d5"], extra[:2])
    np.testing.assert_array_equal(s._db[5].numpy(), extra[1])
    names = [f"d{i}" for i in range(2000)]
    tx, jx = ((pkg.builder(db[:2000], 10, "dot_product", **kw)
               .tree(num_leaves=8, num_leaves_to_search=8)
               .score_brute_force("int8").build(docids=names))
              for pkg, kw in ((scann_torch, dict(device="cpu")),
                              (scann_tpu, {})))
    got = tx.search_batched(q[:4])[0]
    assert all(x in names for row in got for x in row)
    top = [[names[i] for i in r]
           for r in np.argsort(-(q[:4] @ db[:2000].T), axis=1)[:, :10]]
    for g, j, t in zip(got, jx.search_batched(q[:4])[0], top):
        assert len(set(g) & set(t)) >= 8 and len(set(j) & set(t)) >= 8
    for x in (tx, jx):
        for call in (lambda: x.upsert(["new"], extra[:1]),
                     lambda: x.delete(["d1"])):
            with pytest.raises(NotImplementedError,
                               match="does not support dynamic updates"):
                call()
    assert tx.docids == names and len(tx._mut.vectors) == 2000
    assert tx._mut.alive.all() and "d1" in tx._mut.docid_to_id
    assert jx.docids == names + ["new"] and not jx._mut.alive[1]
    stats = tx.get_health_stats()
    assert stats.keys() == jx.get_health_stats().keys()
    assert stats["sum_partition_sizes"] == 2000
    assert stats["avg_quantization_error"] == 0.0
