"""SOAR spilled assignment in the port against scann_tpu.

Pieces, on the same inputs: the two-center tokenization (primaries equal,
secondaries on >= 99.9% of random rows, where an f32 near-tie may round
the other way, and equal on well-separated clusters), cap_partition_sizes
with the primaries' base counts and the forbidden primary (equal tokens),
and dedup_candidates with exact ties and INVALID entries (equal arrays).

Search: scann_tpu builds a SOAR tree-AH index (two slots a row) and
serializes it; the port loads it and, on the same queries, returns the
same top-10 on >= 99.9% of entries with distances within 1e-4 relative, in
int8 lookup (K3's plain version), float32 lookup (K4's) and reconstruct
mode (K2's), on the pruned path (invert and invert_small plans), the
dense scans (the full scan and a plan over MAX_PLAN_WORK) and, in
reconstruct mode, the full scan through K5 (the JAX package's Pallas
kernel in interpret mode).  The pre-reorder budget stays at 15 or under:
SOAR fetches twice it, and from 32 on the JAX merge selects with
approx_max_k (ROADMAP section 3).  A port-built SOAR index is held to
scann_tpu's SOAR recall (within 0.02) and to the port's index without SOAR
(less 0.02, as tests/test_tree_ah.py holds the JAX package), returns no id
twice in a row, and scann_tpu loads it and returns the port's results."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scann_torch
import scann_tpu
from scann_torch.ops import fused_scan as tfs
from scann_torch.ops import pruned_scan as tps
from scann_torch.ops import topk as ttopk
from scann_torch.partitioning import kmeans_tree as tkt
from scann_tpu.ops import pruned_scan as jps
from scann_tpu.ops import topk as jtopk
from scann_tpu.partitioning import kmeans_tree as jkt
from test_torch_tree_ah import _assert_same, _clustered, _recall
import torch_threads  # noqa: F401  (torch threads per xdist worker)

torch.backends.cuda.matmul.allow_tf32 = False

REORDER = 12       # SOAR fetches 24 < 32 candidates
LAMBDA = 1.5


def _random_rows(n=4000, d=32, k=64, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, d)).astype(np.float32)
    c = r.standard_normal((k, d)).astype(np.float32)
    return x, c


def _tokenize_both(x, c):
    want = np.asarray(jkt._tokenize_soar_run(jnp.asarray(x), jnp.asarray(c),
                                             LAMBDA))
    got = tkt._tokenize_soar_run(torch.as_tensor(x), torch.as_tensor(c),
                                 LAMBDA).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    return want, got


def test_tokenize_soar_run_random():
    want, got = _tokenize_both(*_random_rows())
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert (got[:, 1] == want[:, 1]).mean() >= 0.999
    assert (got[:, 1] != got[:, 0]).all()


def test_tokenize_soar_run_separated():
    r = np.random.default_rng(1)
    c = 10.0 * r.standard_normal((40, 32)).astype(np.float32)
    x = (c[r.integers(0, 40, 3000)]
         + 0.3 * r.standard_normal((3000, 32))).astype(np.float32)
    want, got = _tokenize_both(x, c)
    np.testing.assert_array_equal(got, want)


def test_cap_partition_sizes_base_counts_and_forbid():
    x, c = _random_rows(n=3000, k=24, seed=2)
    prim = np.argmin(((x[:, None] - c[None]) ** 2).sum(-1), 1)
    sec = np.asarray(jkt._tokenize_soar_run(jnp.asarray(x), jnp.asarray(c),
                                            LAMBDA))[:, 1]
    base = np.bincount(prim, minlength=24)
    cap = int(np.percentile(base + np.bincount(sec, minlength=24), 60))
    kw = dict(base_counts=base, forbid=prim)
    want = jkt.cap_partition_sizes(x, sec, c, cap, **kw)
    got = tkt.cap_partition_sizes(torch.as_tensor(x), sec, c, cap, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got != sec).any()
    moved = got != sec
    assert (got[moved] != prim[moved]).all()
    total = np.bincount(got, minlength=24) + base
    # The cap binds where room was left: no leaf grew past it.
    grown = np.bincount(got, minlength=24) > np.bincount(sec, minlength=24)
    assert (total[grown] <= cap).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_candidates_ties_and_invalid(seed):
    r = np.random.default_rng(seed)
    vals = r.integers(0, 6, (64, 40)).astype(np.float32) / 4.0
    idx = r.integers(-1, 25, (64, 40)).astype(np.int32)
    vals[idx < 0] = -np.inf
    vals[:, :3] = -np.inf          # invalid scores on valid-looking ids
    want = jtopk.dedup_candidates(jnp.asarray(vals), jnp.asarray(idx))
    got = ttopk.dedup_candidates(torch.as_tensor(vals), torch.as_tensor(idx))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    live = got[1].numpy()
    for row in live:
        row = row[row >= 0]
        assert len(set(row)) == len(row)


# name -> (lookup_type, reorder budget or None)
MODES = {"int8": ("int8", REORDER), "float32": ("float32", None),
         "reconstruct": ("reconstruct", REORDER)}


def _config(builder_fn, db, lookup, reorder, soar=True, **kw):
    b = builder_fn(db, 10, "dot_product", **kw).tree(
        num_leaves=32, num_leaves_to_search=6, training_sample_size=4000,
        soar_lambda=LAMBDA if soar else None)
    b = b.score_ah(2, anisotropic_quantization_threshold=0.2,
                   training_sample_size=4000)
    if reorder is not None:
        b = b.reorder(reorder)
    config = b.create_config()
    return dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type=lookup))


@pytest.fixture(scope="module")
def data():
    return _clustered(n=4000, nq=200, topics=200, seed=4)


@pytest.fixture(scope="module")
def pairs(data, tmp_path_factory):
    """mode -> (JAX searcher, port searcher loaded from its files), each
    built once for the module."""
    db, _ = data
    built = {}

    def get(mode):
        if mode not in built:
            js = scann_tpu.create_searcher(
                db, _config(scann_tpu.builder, db, *MODES[mode]))
            js._fused_interpret = True
            path = str(tmp_path_factory.mktemp("jax_soar_index"))
            js.serialize(path)
            built[mode] = js, scann_torch.load_searcher(path, device="cpu")
        return built[mode]

    return get


@pytest.mark.parametrize("mode", sorted(MODES))
def test_loaded_layout(pairs, mode, data):
    js, ts = pairs(mode)
    db, _ = data
    n = len(db)
    assert ts._num_slots == js._num_slots == 2 * n
    assert ts.datapoint_to_token.shape == (n, 2)
    np.testing.assert_array_equal(np.sort(ts._host["dpid"][ts._host["dpid"]
                                                           >= 0]),
                                  np.repeat(np.arange(n), 2))


@pytest.mark.parametrize("path", ["pruned", "small", "dense", "overflow"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_search_parity(pairs, mode, data, path, monkeypatch):
    """pruned: the invert plan at 6 leaves; small: invert_small (16
    queries x 4 leaves); dense: the full scan (LUT16, or the decoded rows
    in reconstruct mode); overflow: a plan over MAX_PLAN_WORK."""
    js, ts = pairs(mode)
    _, q = data
    kw = {"pruned": dict(leaves_to_search=6),
          "small": dict(leaves_to_search=4),
          "dense": dict(leaves_to_search=ts.part_cfg.num_leaves),
          "overflow": dict(leaves_to_search=5)}[path]
    if path == "small":
        q = q[:16]
    if path == "overflow":
        # The JAX package reads MAX_PLAN_WORK when it traces: its programs
        # are traced again under the patch, and after it.
        monkeypatch.setattr(jps, "MAX_PLAN_WORK", 0)
        monkeypatch.setattr(tps, "MAX_PLAN_WORK", 0)
        monkeypatch.setattr(js, "_compiled", {})
    want = js.search_batched(q, **kw)
    got = ts.search_batched(q, **kw)
    _assert_same(want, got)
    for row in got[0]:
        row = row[row >= 0]
        assert len(set(row)) == len(row)


def test_full_scan_through_k5(pairs, data, monkeypatch):
    """Reconstruct mode at k_pre 8 (32 groups of the 8,192 padded slots
    >= 4 x 8): both packages scan through their fused kernel, then drop
    the repeated ids of the 16 fetched."""
    js, ts = pairs("reconstruct")
    assert ts._recon_mode
    _, q = data
    calls = []
    monkeypatch.setattr(
        tfs, "fused_scan_groupmax",
        lambda *a, _f=tfs.fused_scan_groupmax, **k: (
            calls.append(1), _f(*a, **k))[1])
    rh_j, rh_t = js.reorder_helper, ts.reorder_helper
    js.reorder_helper = ts.reorder_helper = None
    js._compiled = {}
    try:
        kw = dict(leaves_to_search=ts.part_cfg.num_leaves,
                  final_num_neighbors=8)
        want = js.search_batched(q[:128], **kw)
        got = ts.search_batched(q[:128], **kw)
    finally:
        js.reorder_helper, ts.reorder_helper = rh_j, rh_t
        js._compiled = {}
    assert calls
    _assert_same(want, got)


def test_port_built_soar_recall_and_cross_load(data, tmp_path):
    db, q = data
    truth = np.argsort(-(q @ db.T), axis=1)[:, :10]
    cfg_j = _config(scann_tpu.builder, db, "int8", 60)
    js = scann_tpu.create_searcher(db, cfg_j)
    ts = scann_torch.create_searcher(
        db, _config(scann_torch.builder, db, "int8", 60, device="cpu"), "cpu")
    plain = scann_torch.create_searcher(
        db, _config(scann_torch.builder, db, "int8", 60, soar=False,
                    device="cpu"), "cpu")
    assert ts._num_slots == 2 * len(db)
    tok = ts.datapoint_to_token
    assert tok.shape == (len(db), 2) and (tok[:, 0] != tok[:, 1]).mean() > 0.9
    for leaves in (4, 6):
        got = ts.search_batched(q, leaves_to_search=leaves)
        for row in got[0]:
            row = row[row >= 0]
            assert len(set(row)) == len(row)
        r_soar = _recall(got[0], truth)
        r_jax = _recall(js.search_batched(q, leaves_to_search=leaves)[0],
                        truth)
        r_plain = _recall(plain.search_batched(q, leaves_to_search=leaves)[0],
                          truth)
        assert abs(r_soar - r_jax) <= 0.02, (leaves, r_soar, r_jax)
        assert r_soar >= r_plain - 0.02, (leaves, r_soar, r_plain)
    small = dict(leaves_to_search=6, pre_reorder_num_neighbors=REORDER)
    got = ts.search_batched(q, **small)
    ts.serialize(str(tmp_path))
    back = scann_tpu.load_searcher(str(tmp_path))
    assert back._num_slots == 2 * len(db)
    _assert_same(back.search_batched(q, **small), got)
    again = scann_torch.load_searcher(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(again.search_batched(q, **small)[0],
                                  got[0])


def test_tree_x_ignores_soar_and_avq(data, caplog):
    """Tree-X reads neither setting in either package: the index, and so
    every result, is the one built without them; the port says so once."""
    db, q = data

    def build(pkg, **kw):
        extra = dict(device="cpu") if pkg is scann_torch else {}
        return pkg.builder(db, 10, "dot_product", **extra).tree(
            num_leaves=32, num_leaves_to_search=6, training_sample_size=4000,
            **kw).score_brute_force("int8").build()

    for pkg in (scann_tpu, scann_torch):
        plain = build(pkg).search_batched(q)[0]
        for kw in (dict(soar_lambda=LAMBDA), dict(avq=2.0),
                   dict(soar_lambda=LAMBDA, avq=2.0)):
            caplog.clear()
            with caplog.at_level("WARNING", logger="scann_torch"):
                s = build(pkg, **kw)
            np.testing.assert_array_equal(s.search_batched(q)[0], plain)
            if pkg is scann_torch:
                warned = [r.getMessage() for r in caplog.records
                          if "ignores" in r.getMessage()]
                assert len(warned) == 1
                assert all(name in warned[0] for name in kw)
