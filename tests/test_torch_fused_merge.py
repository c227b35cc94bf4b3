"""The fused merge (K6 and its per-pair assembly) of the port against
scann_tpu, bit for bit.

One packed survivor block, scored by the JAX package's ``score_work_xla``
on the plan of tests/test_fused_merge.py, goes through both packages'
``merge_candidates_fused``: the JAX package on its XLA route and with its
Pallas kernel in interpret mode, the port on the pair-major route CPU
tensors take (``merge_pairs_torch``).  The group-major route CUDA tensors
take (``merge_pairs_groups`` over ``merge_groups``, whose CPU path is the
plain version of the CUDA kernel csrc/merge_groups.cu) is held against the
pair-major route pair by pair.
The merge is integer and compare work plus one float add of the pair bias,
so values and slots are held EQUAL, as are the kernel outputs (selected
keys and tiles) on the rows of active groups."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_torch.ops import pruned_scan as tps
from scann_tpu.ops import pruned_scan as jps
import torch_threads  # noqa: F401  (torch threads per xdist worker)


def _layout_and_plan(seed=3, num_leaves=12, b=96, l=5, d=128, kpg=8):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(100, 1200, num_leaves)
    leaf = np.repeat(np.arange(num_leaves), sizes).astype(np.int64)
    order, tile_start, ntiles, num_tiles = jps.build_layout_host(
        leaf, num_leaves, seed=0)
    rows_flat = np.zeros((num_tiles * jps.TILE, d), np.float32)
    live = order >= 0
    rows_flat[live] = rng.standard_normal((len(leaf), d)).astype(
        np.float32)[order[live]]
    bias = np.where(live, 0.0, -1e30).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    sel = np.stack([rng.choice(num_leaves, l, replace=False)
                    for _ in range(b)]).astype(np.int32)
    valid = np.ones((b, l), bool)
    valid[::7, -1] = False  # some dead pairs
    mnt = int(ntiles.max())
    g_pad, w_pad = jps.plan_capacities(b, l, num_leaves, num_tiles, mnt)
    jplan = jps.invert(jnp.asarray(sel), jnp.asarray(valid),
                       jnp.asarray(tile_start), jnp.asarray(ntiles), mnt,
                       g_pad, w_pad)
    qg_rows = jnp.take(jnp.asarray(q, jnp.bfloat16), jplan.qg_query, axis=0)
    packed = np.array(jps.score_work_xla(
        jplan, qg_rows,
        jnp.asarray(rows_flat.reshape(num_tiles, jps.TILE, d), jnp.bfloat16),
        jnp.asarray(bias.reshape(num_tiles, jps.TILE)), measure_l2=False,
        kpg=kpg))
    pair_bias = rng.standard_normal((b, l)).astype(np.float32)
    t = torch.from_numpy
    tplan = tps.invert(t(sel), t(valid), t(tile_start), t(ntiles), mnt,
                       g_pad, w_pad)
    jargs = (jplan, jnp.asarray(packed), jnp.asarray(sel),
             jnp.asarray(valid), jnp.asarray(tile_start),
             jnp.asarray(ntiles), mnt)
    targs = (tplan, t(packed), t(sel), t(valid), t(tile_start), t(ntiles),
             mnt)
    return jargs, targs, pair_bias


def _equal(got, want):
    (gv, gs), (wv, ws) = got, want
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gv.numpy().view(np.int32),
                                  np.asarray(wv).view(np.int32))


@pytest.mark.parametrize("k,kpg,with_bias", [(10, 8, True), (30, 8, True),
                                             (1, 8, False), (32, 16, True)])
@pytest.mark.parametrize("route", ["pairs_vs_xla", "pairs_vs_interpret"])
def test_fused_merge_bit_equal_to_jax(k, kpg, with_bias, route):
    jargs, targs, pair_bias = _layout_and_plan(seed=3 + k, kpg=kpg)
    want = jps.merge_candidates_fused(
        *jargs, k, pair_bias=jnp.asarray(pair_bias) if with_bias else None,
        interpret=route == "pairs_vs_interpret")
    got = tps.merge_candidates_fused(
        *targs, k, pair_bias=torch.from_numpy(pair_bias) if with_bias
        else None)
    assert got[0].shape == (96, min(k, 5 * k)) and got[1].dtype == torch.int32
    _equal(got, want)


def _both_routes(targs, k, pair_bias=None, kpg=8):
    """Per-pair (vals, slots) of the pair-major and the group-major route
    on one block."""
    plan, packed, sel, valid, tile_start, ntiles, mnt = targs
    w = packed.shape[-1]
    flat, nt1, t01, bias1, valid1 = tps.fused_pair_operands(
        plan, sel, valid, tile_start, ntiles, pair_bias)
    kw = dict(kgp=w // mnt, tile=tps.TILE, k=k)
    pairs = tps.merge_pairs_torch(packed.reshape(-1, w), flat, nt1, t01,
                                  bias1, valid1, **kw)
    groups = tps.merge_pairs_groups(plan, packed, ntiles, flat, t01, bias1,
                                    valid1, **kw)
    return pairs, groups


@pytest.mark.parametrize("k", [10, 30])
def test_both_port_routes_agree_and_cpu_calls_count_no_launch(k):
    _, targs, pair_bias = _layout_and_plan(seed=11)
    before = tps.launches_merge
    (pv, ps_), (gv, gs) = _both_routes(targs, k, torch.from_numpy(pair_bias))
    assert pv.shape == (96 * 5, k)
    assert torch.equal(ps_, gs)
    assert torch.equal(pv.view(torch.int32), gv.view(torch.int32))
    assert tps.launches_merge == before     # only kernel launches count


@pytest.mark.parametrize("tile,kpg,k", [(512, 8, 10), (512, 8, 30),
                                        (256, 4, 10)])
def test_k6_plain_version_bit_equal_to_pallas_interpret(tile, kpg, k):
    """merge_groups (CPU path: merge_groups_torch) against
    merge_groups_pallas(interpret=True) on the rows of active groups.  The
    tree-SQ shape (256-slot tiles, 4 survivors) reads the same block as
    two tiles of 8 groups."""
    jargs, targs, _ = _layout_and_plan(seed=5 + k, kpg=8)
    jplan, packed = jargs[0], np.asarray(jargs[1])
    mnt = jargs[6]
    if tile == 256:
        # Reinterpret each 512-slot segment (8 passes x 16 groups) as a
        # block of 4 passes x 8 groups over twice the tiles.
        mnt, kgp = mnt * 4, 32
    else:
        kgp = kpg * tps.GP
    nt = np.asarray(jargs[5])[np.asarray(jplan.qg_leaf)].astype(np.int32)
    nt = nt * (4 if tile == 256 else 1)
    wm, wt = jps.merge_groups_pallas(jnp.asarray(packed), jnp.asarray(nt),
                                     kgp=kgp, tile=tile, k=k, interpret=True)
    gm, gt = tps.merge_groups(torch.from_numpy(packed.copy()),
                              torch.from_numpy(nt), kgp=kgp, tile=tile, k=k)
    live = np.asarray(jplan.work_active).reshape(len(nt), -1)[:, 0] == 1
    assert live.any() and not live.all()
    np.testing.assert_array_equal(gm.numpy()[live], np.asarray(wm)[live])
    np.testing.assert_array_equal(gt.numpy()[live], np.asarray(wt)[live])
    assert gm.shape == (len(nt), tps.QG, k)


def test_fused_matches_stratified_all_hot():
    """With every leaf hot the stratified merge sees the full survivor
    lists, so the fused top-k selects the same slots with the same values
    (both clear the 9 identity bits of a value)."""
    _, targs, pair_bias = _layout_and_plan(seed=7)
    pb = torch.from_numpy(pair_bias)
    v_f, s_f = tps.merge_candidates_fused(*targs, 10, pair_bias=pb)
    v_s, s_s = tps.merge_candidates(*targs, 10, pair_bias=pb, hot=5)
    for row in range(s_f.shape[0]):
        got = set(s_f[row].tolist()) - {-1}
        want = set(s_s[row].tolist()) - {-1}
        # Equal values may swap across the k boundary; nothing else may.
        assert len(got ^ want) <= 1, (row, got ^ want)
    torch.testing.assert_close(v_f, v_s, rtol=0, atol=0)


def test_fused_invalid_pairs_produce_no_candidates():
    jargs, targs, _ = _layout_and_plan(seed=2, b=16, l=3)
    plan, packed, sel, valid, tile_start, ntiles, mnt = targs
    valid = torch.zeros_like(valid)
    plan = tps.invert(sel, valid, tile_start, ntiles, mnt,
                      plan.qg_query.shape[0], plan.work_tile.shape[0])
    v, s = tps.merge_candidates_fused(plan, packed, sel, valid, tile_start,
                                      ntiles, mnt, 10)
    assert torch.all(s == -1) and torch.all(torch.isneginf(v))
    for v, s in _both_routes((plan,) + targs[1:2] + (sel, valid)
                             + targs[4:], 10):
        assert torch.all(s == -1) and torch.all(torch.isneginf(v))


def test_fused_merge_policy_reads_the_environment_at_call_time(monkeypatch):
    monkeypatch.delenv("SCANN_TORCH_FUSED_MERGE", raising=False)
    assert not tps.fused_merge_enabled(10)            # off by default
    monkeypatch.setenv("SCANN_TORCH_FUSED_MERGE", "1")
    assert tps.fused_merge_enabled(10) and tps.fused_merge_enabled(32)
    assert not tps.fused_merge_enabled(33)            # over _FUSED_MAX_K
    monkeypatch.setenv("SCANN_TORCH_FUSED_MERGE", "0")
    assert not tps.fused_merge_enabled(10)
    assert tps._FUSED_MAX_K == jps._FUSED_MAX_K == 32
    assert tps._BIG_NEG_F == jps._BIG_NEG_F == -2.0 ** 127


@pytest.mark.parametrize("engine,tile", [("tree_sq", 256), ("tree_ah", 512)])
def test_tree_sq_search_with_the_fused_merge_on_in_both_packages(
        tmp_path, monkeypatch, engine, tile):
    """End to end on a JAX-built index, through the merge both engines
    share: tree-SQ (256-slot tiles, pair bias q.c_leaf) and tree-AH (int8
    lookup through K3's plain version, 512-slot tiles, pair bias q.c_leaf
    of its residual codes).  With both packages' switches on, the same
    ids and distances; and the port's fused merge finds what its
    stratified merge finds."""
    import scann_tpu
    import scann_torch
    r = np.random.default_rng(4)
    centers = r.standard_normal((200, 32)).astype(np.float32)
    db = (centers[r.integers(0, 200, 8000)]
          + 0.5 * r.standard_normal((8000, 32))).astype(np.float32)
    q = (centers[r.integers(0, 200, 150)]
         + 0.5 * r.standard_normal((150, 32))).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    b = scann_tpu.builder(db, 10, "dot_product").tree(
        num_leaves=32, num_leaves_to_search=6, training_sample_size=4000)
    js = (b.score_brute_force(quantize="int8") if engine == "tree_sq"
          else b.score_ah(2, anisotropic_quantization_threshold=0.2,
                          training_sample_size=4000)).build()
    js.serialize(str(tmp_path))
    ts = scann_torch.load_searcher(str(tmp_path), device="cpu")
    off = ts.search_batched(q, leaves_to_search=6)
    monkeypatch.setenv("SCANN_TPU_FUSED_MERGE", "1")
    monkeypatch.setenv("SCANN_TORCH_FUSED_MERGE", "1")
    js._compiled = {}
    calls = []
    monkeypatch.setattr(
        tps, "merge_candidates_fused",
        lambda *a, _f=tps.merge_candidates_fused, **k: (
            calls.append(k.get("tile")), _f(*a, **k))[1])
    wi, wd = js.search_batched(q, leaves_to_search=6)
    gi, gd = ts.search_batched(q, leaves_to_search=6)
    assert calls == [tile]
    # By membership: two candidates of different leaves whose totals tie
    # to the last bit of the f32 pair bias may swap places.
    agree = (wi[:, :, None] == gi[:, None, :]).any(-1).mean()
    assert agree >= 0.999, agree
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    found = (off[0][:, :, None] == gi[:, None, :]).any(-1)
    assert found.mean() >= 0.99, found.mean()
