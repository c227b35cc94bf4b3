"""Card tests of mutation (marker ``cuda``; they skip without a card).
Indexes built on the card with docids take upserts (into free slots and
past them, so the layout grows), updates, deletes and re-inserts; then
every K3, K4, K2 and K5 launch of their searches is held against its plain
version on the mutated layout (K3 bit-equal; K2 and K4 values within
2^-14 relative plus 1e-5 and identities >= 99.99% / 99.9%; K5 values
within 1e-5 relative plus 1e-5 and slots >= 99.9%, as in
tests/test_torch_cuda.py),
and the mutated index, serialized, returns on the CPU plain path what it
returns on the card.  Also: split / merge maintenance and brute force on
the card.  On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_mutation.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import scann_torch
from scann_torch.ops import fused_scan
from scann_torch.ops import pruned_lut
from scann_torch.ops import pruned_scan as ps
import torch_threads  # noqa: F401  (torch threads per xdist worker)

pytestmark = pytest.mark.cuda

N = 20000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _corpus(seed=7, n=N + 4000, d=48):
    r = np.random.default_rng(seed)
    c = r.standard_normal((64, d))
    db = (c[r.integers(0, 64, n)] + 0.3 * r.standard_normal((n, d))
          ).astype(np.float32)
    q = (c[r.integers(0, 64, 256)] + 0.3 * r.standard_normal((256, d))
         ).astype(np.float32)
    return db, q


def _mutate(s, db):
    """New rows, updates (one docid twice), deletes, re-inserts, and more
    new rows than the free slots hold."""
    free = int((s._host["dpid"] < 0).sum()) if hasattr(s, "_host") else 0
    s.upsert(list(range(N, N + 500)), db[N:N + 500])
    s.upsert(list(range(10, 40)) + [12], db[N + 500:N + 531])
    s.delete(list(range(100, 600)))
    s.upsert([100, 101], db[100:102])
    grow = min(free + 300, len(db) - N - 600)
    s.upsert(list(range(N + 600, N + 600 + grow)), db[N + 600:N + 600 + grow])


def _ids(idx):
    return np.array([[-1 if x is None else x for x in row] for row in idx],
                    np.int32)


def _same_as_cpu(s, q, measure, tmp_path, **kw):
    """Search the mutated index itself, then hold its serialization loaded
    on the card against the same files loaded on the CPU.  (A reload
    recomputes the reconstruct mean from the codes, where the mutated
    index keeps the one of its last rebuild, so under squared L2 the
    reload, not the mutated index, is the CPU's counterpart.)"""
    gi, _ = s.search_batched(q, **kw)
    assert not set(range(102, 600)) & set(_ids(gi).reshape(-1).tolist())
    s.serialize(str(tmp_path))
    c = scann_torch.load_searcher(str(tmp_path), device="cpu")
    gi, gd = scann_torch.load_searcher(str(tmp_path), device=s.device
                                       ).search_batched(q, **kw)
    ci, cd = c.search_batched(q, **kw)
    gi, ci = _ids(gi), _ids(ci)
    assert (gi[:, :, None] == ci[:, None, :]).any(-1).mean() >= 0.999
    same = (gi == ci) & (gi >= 0)
    scale = np.abs(cd)
    if measure == "squared_l2":
        x = c._mut.vectors.astype(np.float64)
        rows = np.array([[c._mut.docid_to_id.get(int(d), 0) for d in r]
                         for r in ci])
        scale = scale + (q ** 2).sum(1)[:, None] + (x[rows] ** 2).sum(-1)
    assert np.all(np.abs(gd - cd)[same] <= 1e-4 * scale[same] + 1e-6)
    gone = set(range(102, 600))
    assert not gone & set(gi.reshape(-1).tolist())


def _hold_kernels(monkeypatch, held):
    def k3(plan, q_rows, *rest, _f=pruned_lut.score_work_lut, **kw):
        got = _f(plan, q_rows, *rest, **kw)
        want = pruned_lut.score_work_torch_lut(
            plan, q_rows[plan.qg_query.long()], *rest, **kw)
        a, b = _active(plan, got, want, kw["kpg"])
        assert a.numel() and torch.equal(a, b)
        held.append("k3")
        return got

    def k2(plan, *args, _f=ps.score_work, **kw):
        got = _f(plan, *args, **kw)
        a, b = _active(plan, got, ps.score_work_torch(plan, *args, **kw),
                       kw["kpg"])
        va, vb = ps._unpack(a)[0].double(), ps._unpack(b)[0].double()
        assert a.numel()
        assert torch.all((va - vb).abs() <= 2.0 ** -14 * vb.abs() + 1e-5)
        assert ((a & 511) == (b & 511)).double().mean() >= 0.9999
        held.append("k2")
        return got

    def k5(q_bf, rows, bias, _f=fused_scan.fused_scan_groupmax, **kw):
        (gv, gi) = got = _f(q_bf, rows, bias, **kw)
        wv, wi = fused_scan.fused_scan_groupmax_torch(q_bf, rows, bias, **kw)
        assert torch.all((gv - wv).abs() <= 1e-5 * wv.abs() + 1e-5)
        assert (gi == wi).double().mean() >= 0.999
        held.append("k5")
        return got

    def k4(plan, *args, _f=pruned_lut.score_work_codes, **kw):
        got = _f(plan, *args, **kw)
        a, b = _active(plan, got, pruned_lut.score_work_torch_codes(
            plan, *args, **kw), kw["kpg"])
        va, vb = ps._unpack(a)[0].double(), ps._unpack(b)[0].double()
        assert a.numel()
        assert torch.all((va - vb).abs() <= 2.0 ** -14 * vb.abs() + 1e-5)
        assert ((a & 511) == (b & 511)).double().mean() >= 0.999
        held.append("k4")
        return got

    monkeypatch.setattr(pruned_lut, "score_work_lut", k3)
    monkeypatch.setattr(pruned_lut, "score_work_codes", k4)
    monkeypatch.setattr(ps, "score_work", k2)
    monkeypatch.setattr(fused_scan, "fused_scan_groupmax", k5)


def _active(plan, got, want, kpg):
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, 128, mnt, kpg * 16)
    return got.reshape(act.shape)[act], want.reshape(act.shape)[act]


def _tree_ah(db, measure, lookup, tree=True, **tree_kw):
    b = scann_torch.builder(db[:N], 10, measure)
    if tree:
        b = b.tree(num_leaves=32, num_leaves_to_search=4,
                   training_sample_size=10000, **tree_kw)
    config = (b.score_ah(2, anisotropic_quantization_threshold=0.2)
              .reorder(20).create_config())
    return scann_torch.create_searcher(
        db[:N], dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
            config.asymmetric_hash, lookup_type=lookup)), "cuda",
        docids=list(range(N)))


@pytest.mark.parametrize("lookup,kernel", [("int8", "k3"),
                                           ("float32", "k4")])
def test_k3_and_k4_on_a_mutated_lut_index(cuda, lookup, kernel, tmp_path,
                                          monkeypatch):
    db, q = _corpus()
    s = _tree_ah(db, "dot_product", lookup)
    slots = len(s._host["dpid"])
    _mutate(s, db)
    assert len(s._host["dpid"]) > slots            # the layout grew
    held = []
    _hold_kernels(monkeypatch, held)
    _same_as_cpu(s, q, "dot_product", tmp_path, leaves_to_search=4)
    assert kernel in held


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_k2_and_k5_on_a_mutated_reconstruct_index(cuda, measure, tmp_path,
                                                  monkeypatch):
    """Full scans before and after the mutations (the decoded rows are
    written in place until the layout grows); under squared L2 the mean
    stays that of the build until the layout grows, then it is
    recomputed."""
    db, q = _corpus(seed=8)
    s = _tree_ah(db, measure, "reconstruct")
    s.search_batched(q[:8], leaves_to_search=10 ** 6)
    mean0 = None if s._recon_mean is None else s._recon_mean.clone()
    s.upsert([N + 3999], db[-1:])
    if mean0 is not None:
        assert torch.equal(s._recon_mean, mean0)
    _mutate(s, db)
    if mean0 is not None:
        assert not torch.equal(s._recon_mean, mean0)
    held = []
    _hold_kernels(monkeypatch, held)
    _same_as_cpu(s, q, measure, tmp_path, leaves_to_search=4)
    _same_as_cpu(s, q, measure, tmp_path, leaves_to_search=10 ** 6)
    assert held.count("k2") >= 1 and held.count("k5") >= 1


def test_k5_on_a_mutated_index_without_a_tree(cuda, tmp_path, monkeypatch):
    db, q = _corpus(seed=9)
    s = _tree_ah(db, "dot_product", "reconstruct", tree=False)
    rows = s._recon_rows
    s.upsert([N + 3999], db[-1:])
    assert s._recon_rows is rows                  # written in place
    _mutate(s, db)
    held = []
    _hold_kernels(monkeypatch, held)
    _same_as_cpu(s, q, "dot_product", tmp_path)
    assert held.count("k5") >= 1


def test_maintenance_on_the_card(cuda):
    """online_incremental: skewed upserts split the biggest leaf, deletes
    that drain a leaf merge it; searches launch K3 and return live
    docids."""
    db, q = _corpus(seed=10)
    s = _tree_ah(db, "dot_product", "int8", incremental_threshold=0.05,
                 incremental_mode="online_incremental")
    nl = s.partitioner.num_leaves
    prim = s.datapoint_to_token[:, 0]
    big = int(np.bincount(prim).argmax())
    r = np.random.default_rng(3)
    rows = db[r.choice(np.nonzero(prim == big)[0], 1100)]
    s.upsert([f"s{i}" for i in range(1100)], rows + 0.01 * r.standard_normal(
        rows.shape).astype(np.float32))
    assert s.partitioner.num_leaves > nl
    assert s._mut.mutations_since_rebuild == 0
    prim = s.datapoint_to_token[:, 0]
    counts = np.bincount(prim[s._mut.alive], minlength=s.partitioner.num_leaves)
    leaf = int(np.argmin(np.where(counts > 0, counts, 1 << 30)))
    drained = [s.docids[i] for i in np.nonzero(s._mut.alive
                                               & (prim == leaf))[0]]
    merged, merge = [], s._merge_partition
    s._merge_partition = lambda t: (merged.append(t), merge(t))[1]
    s.delete(drained + [d for d in range(2000, 3200) if d not in drained])
    assert s._mut.mutations_since_rebuild == 0
    assert leaf in merged
    before = pruned_lut.launches_lut
    idx, dist = s.search_batched(q, leaves_to_search=4)
    assert pruned_lut.launches_lut > before and np.isfinite(dist).all()
    live = s._mut.docid_to_id
    assert all(d in live for row in idx for d in row)


@pytest.mark.parametrize("quantize", ["float32", "int8"])
def test_brute_force_mutation_on_the_card(cuda, quantize, tmp_path):
    db, q = _corpus(seed=11)
    s = scann_torch.builder(db[:N], 10, "squared_l2").score_brute_force(
        quantize).build(docids=list(range(N)))
    _mutate(s, db)
    assert s._db.shape[0] > N
    _same_as_cpu(s, q, "squared_l2", tmp_path)
