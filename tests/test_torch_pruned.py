"""Pruned-path pieces of scann_torch against scann_tpu on the same inputs:
the work plans (invert, invert_small), the packed survivor selection, the
stratified merge, the tile-major layout, and the K1 scorer's plain torch
version against the JAX package's XLA twin and its Pallas kernel run in
interpret mode.

Tolerances: plans, layouts and bit-level selections are equal; the K1
plain version's unpacked values agree within rtol 2^-14 (the <= 2^-15
identity perturbation plus summation order; int8 x bf16 products are exact
in f32) and its packed identities on >= 99.9% of active survivors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_torch.ops import pruned_scan as tps
from scann_torch.ops import pruned_sq as tsq
from scann_tpu.ops import pruned_scan as jps
from scann_tpu.ops import pruned_sq as jsq
import torch_threads  # noqa: F401  (torch threads per xdist worker)

TILE = 256
K1_RTOL, K1_MIN_ID_AGREE = 2.0 ** -14, 0.999


def _layout(ntiles):
    ntiles = np.asarray(ntiles, np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    return tile_start, ntiles


def _selection(r, b, l, num_leaves, p_valid=0.85):
    sel = np.stack([r.choice(num_leaves, l, replace=False)
                    for _ in range(b)]).astype(np.int32)
    return sel, r.random((b, l)) < p_valid


def _to_torch(plan):
    return tps.WorkPlan(*(torch.from_numpy(np.array(a)) for a in plan))


def _jax_plan(sel, valid, tile_start, ntiles, small):
    mnt = int(ntiles.max())
    args = (jnp.asarray(sel), jnp.asarray(valid), jnp.asarray(tile_start),
            jnp.asarray(ntiles))
    if small:
        return jps.invert_small(*args, mnt)
    g_pad, w_pad = jps.plan_capacities(sel.shape[0], sel.shape[1],
                                       len(ntiles), int(ntiles.sum()), mnt)
    return jps.invert(*args, mnt, g_pad, w_pad)


def _torch_plan(sel, valid, tile_start, ntiles, small):
    mnt = int(ntiles.max())
    args = (torch.from_numpy(sel), torch.from_numpy(valid),
            torch.from_numpy(tile_start), torch.from_numpy(ntiles))
    if small:
        return tps.invert_small(*args, mnt)
    g_pad, w_pad = tps.plan_capacities(sel.shape[0], sel.shape[1],
                                       len(ntiles), int(ntiles.sum()), mnt)
    return tps.invert(*args, mnt, g_pad, w_pad)


@pytest.mark.parametrize("small,b,l", [(False, 96, 5), (False, 300, 3),
                                       (True, 8, 4)])
def test_invert_plans_equal(small, b, l):
    r = np.random.default_rng(b)
    tile_start, ntiles = _layout(r.integers(1, 4, 9))
    sel, valid = _selection(r, b, l, 9)
    want = _jax_plan(sel, valid, tile_start, ntiles, small)
    got = _torch_plan(sel, valid, tile_start, ntiles, small)
    for name in tps.WorkPlan._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == np.int32 and g.shape == w.shape, name
        if name.startswith("pair_"):
            np.testing.assert_array_equal(g[valid], w[valid], err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_pack_unpack_and_group_top_packed_bit_identical():
    r = np.random.default_rng(7)
    g = r.standard_normal((5, 8, 32, 16)).astype(np.float32)
    t = r.integers(0, 16, 5).astype(np.int32)
    for kpg in (1, 4, 8):
        want = jps._group_top_packed(jnp.asarray(g),
                                     jnp.asarray(t)[:, None, None, None],
                                     axis=2, cat_axis=1, kpg=kpg)
        got = tps._group_top_packed(torch.from_numpy(g),
                                    torch.from_numpy(t)[:, None, None, None],
                                    axis=2, cat_axis=1, kpg=kpg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    arg = r.integers(0, 32, g.shape).astype(np.int32)
    tt = r.integers(0, 16, g.shape).astype(np.int32)
    packed = np.array(jps._pack(jnp.asarray(g), jnp.asarray(arg),
                                  jnp.asarray(tt)))
    np.testing.assert_array_equal(
        tps._pack(torch.from_numpy(g), torch.from_numpy(arg),
                  torch.from_numpy(tt)).numpy(), packed)
    for got_part, want_part in zip(tps._unpack(torch.from_numpy(packed)),
                                   jps._unpack(jnp.asarray(packed))):
        np.testing.assert_array_equal(got_part.numpy(),
                                      np.asarray(want_part))


def _k1_case(seed, small, d=16, restrict=True):
    """A small tree-SQ scoring problem: layout, plan, int8 tiles, planes."""
    r = np.random.default_rng(seed)
    nl = 7
    tile_start, ntiles = _layout(r.integers(1, 3, nl))
    num_tiles = int(ntiles.sum())
    b, l = (6, 3) if small else (80, 4)
    sel, valid = _selection(r, b, l, nl)
    rows = r.integers(-127, 128, (num_tiles, TILE, d)).astype(np.int8)
    scale = r.uniform(1e-3, 1e-2, (num_tiles, TILE, 1)).astype(np.float32)
    bias = (-r.uniform(0, 1, (num_tiles, TILE, 1))).astype(np.float32)
    bias[r.random(bias.shape) < 0.1] = -1e30          # padded slots
    if restrict:
        bias = bias + np.where(r.random(bias.shape) < 0.2, -1e30,
                               0.0).astype(np.float32)
    q = r.standard_normal((b, d)).astype(np.float32)
    return dict(sel=sel, valid=valid, tile_start=tile_start, ntiles=ntiles,
                rows=rows, scale=scale, bias=bias, q=q, small=small)


def _active_segments(packed, plan, kpg):
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    act = np.asarray(plan.work_active).reshape(g_pad, mnt).astype(bool)
    p = np.asarray(packed).reshape(g_pad, 128, mnt, kpg * 8)
    return p.transpose(0, 2, 1, 3)[act]                 # (n_active, QG, seg)


def _assert_k1_close(got, want):
    gv = (got & ~np.int32(511)).view(np.float32).astype(np.float64)
    wv = (want & ~np.int32(511)).view(np.float32).astype(np.float64)
    np.testing.assert_allclose(gv, wv, rtol=K1_RTOL, atol=1e-7)
    agree = np.mean((got & 511) == (want & 511))
    assert agree >= K1_MIN_ID_AGREE, agree


@pytest.mark.parametrize("measure_l2", [False, True])
@pytest.mark.parametrize("kpg", [4, 8])
@pytest.mark.parametrize("small", [True, False])
def test_k1_plain_version_matches_xla_twin(measure_l2, kpg, small):
    c = _k1_case(10 + kpg + 2 * measure_l2, small)
    jplan = _jax_plan(c["sel"], c["valid"], c["tile_start"], c["ntiles"],
                      small)
    q_bf = jnp.asarray(c["q"]).astype(jnp.bfloat16)
    jqg = jnp.take(q_bf, jplan.qg_query, axis=0)
    want = jsq.score_work_xla_sq(jplan, jqg, jnp.asarray(c["rows"]),
                                 jnp.asarray(c["scale"]),
                                 jnp.asarray(c["bias"]),
                                 measure_l2=measure_l2, kpg=kpg)
    tplan = _to_torch(jplan)
    tqg = torch.from_numpy(c["q"]).to(torch.bfloat16)[tplan.qg_query.long()]
    got = tsq.score_work_torch_sq(tplan, tqg, torch.from_numpy(c["rows"]),
                                  torch.from_numpy(c["scale"]),
                                  torch.from_numpy(c["bias"]),
                                  measure_l2=measure_l2, kpg=kpg,
                                  work_chunk=5)
    assert got.shape == want.shape and got.dtype == torch.int32
    _assert_k1_close(_active_segments(got.numpy(), jplan, kpg),
                     _active_segments(want, jplan, kpg))


@pytest.mark.parametrize("measure_l2", [False, True])
def test_k1_plain_version_matches_pallas_interpret(measure_l2):
    """Against the TPU kernel itself, run in Pallas interpret mode as the
    JAX package's own tests run it."""
    c = _k1_case(20 + measure_l2, small=True)
    jplan = _jax_plan(c["sel"], c["valid"], c["tile_start"], c["ntiles"],
                      True)
    jqg = jnp.take(jnp.asarray(c["q"]).astype(jnp.bfloat16), jplan.qg_query,
                   axis=0)
    want = jsq.score_work_pallas_sq(
        jplan, jqg, jnp.asarray(c["rows"]), jnp.asarray(c["scale"]),
        jnp.asarray(c["bias"]), measure_l2=measure_l2, interpret=True, kpg=4)
    tplan = _to_torch(jplan)
    tqg = torch.from_numpy(c["q"]).to(torch.bfloat16)[tplan.qg_query.long()]
    got = tsq.score_work_torch_sq(tplan, tqg, torch.from_numpy(c["rows"]),
                                  torch.from_numpy(c["scale"]),
                                  torch.from_numpy(c["bias"]),
                                  measure_l2=measure_l2, kpg=4)
    _assert_k1_close(_active_segments(got.numpy(), jplan, 4),
                     _active_segments(want, jplan, 4))


def test_k1_plain_version_matches_xla_twin_past_296_dims():
    """d_pad 392: a width the kernel's shared memory once refused (above
    296) and the card now serves."""
    c = _k1_case(50, small=False, d=392)
    jplan = _jax_plan(c["sel"], c["valid"], c["tile_start"], c["ntiles"],
                      False)
    jqg = jnp.take(jnp.asarray(c["q"]).astype(jnp.bfloat16), jplan.qg_query,
                   axis=0)
    want = jsq.score_work_xla_sq(jplan, jqg, jnp.asarray(c["rows"]),
                                 jnp.asarray(c["scale"]),
                                 jnp.asarray(c["bias"]), measure_l2=True,
                                 kpg=4)
    tplan = _to_torch(jplan)
    tqg = torch.from_numpy(c["q"]).to(torch.bfloat16)[tplan.qg_query.long()]
    got = tsq.score_work_torch_sq(tplan, tqg, torch.from_numpy(c["rows"]),
                                  torch.from_numpy(c["scale"]),
                                  torch.from_numpy(c["bias"]),
                                  measure_l2=True, kpg=4)
    _assert_k1_close(_active_segments(got.numpy(), jplan, 4),
                     _active_segments(want, jplan, 4))


def test_k1_shared_memory_rule():
    """A K1 block's shared memory (csrc/tile_mma.cuh) takes no d_pad: the
    dimension axis streams through a ring of 32-dimension chunks.  The
    staged survivors fit over the ring at every kpg the wrapper takes, so
    it is one size, within what an H100 block may use."""
    sizes = {tps.tile_smem_bytes("int8", kpg)
             for kpg in range(1, tps.SUBP + 1)}
    assert sizes == {256 * 8 + 4 * (256 * 32 + 64 * 80) + 256 * 80}
    assert max(sizes) <= tps._SMEM_LIMIT


def test_k1_wrapper_on_cpu_takes_plain_path_without_launch():
    c = _k1_case(30, small=True)
    plan = _torch_plan(c["sel"], c["valid"], c["tile_start"], c["ntiles"],
                       True)
    qg = torch.from_numpy(c["q"]).to(torch.bfloat16)[plan.qg_query.long()]
    args = (plan, qg, torch.from_numpy(c["rows"]),
            torch.from_numpy(c["scale"]), torch.from_numpy(c["bias"]))
    before = tsq.launches
    got = tsq.score_work_sq(*args, measure_l2=False, kpg=4)
    assert tsq.launches == before
    want = tsq.score_work_torch_sq(*args, measure_l2=False, kpg=4)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("hot", [2, 8])
@pytest.mark.parametrize("small", [True, False])
def test_merge_candidates_equal_given_same_packed(hot, small):
    """Same packed survivors -> the same (vals, slots); garbage (NaN) in
    inactive segments must not change the port's result."""
    c = _k1_case(40 + hot, small)
    jplan = _jax_plan(c["sel"], c["valid"], c["tile_start"], c["ntiles"],
                      small)
    jqg = jnp.take(jnp.asarray(c["q"]).astype(jnp.bfloat16), jplan.qg_query,
                   axis=0)
    packed = np.asarray(jsq.score_work_xla_sq(
        jplan, jqg, jnp.asarray(c["rows"]), jnp.asarray(c["scale"]),
        jnp.asarray(c["bias"]), measure_l2=False, kpg=4))
    r = np.random.default_rng(hot)
    pair_bias = r.standard_normal(c["sel"].shape).astype(np.float32)
    mnt = int(c["ntiles"].max())
    want = jps.merge_candidates(
        jplan, jnp.asarray(packed), jnp.asarray(c["sel"]),
        jnp.asarray(c["valid"]), jnp.asarray(c["tile_start"]),
        jnp.asarray(c["ntiles"]), mnt, 10, pair_bias=jnp.asarray(pair_bias),
        hot=hot, tile=TILE)
    g_pad = packed.shape[0]
    act = np.asarray(jplan.work_active).reshape(g_pad, 1, mnt, 1) == 1
    dirty = packed.reshape(g_pad, 128, mnt, -1).copy()
    dirty[np.broadcast_to(~act, dirty.shape)] = np.float32(np.nan).view(
        np.int32)
    got = tps.merge_candidates(
        _to_torch(jplan), torch.from_numpy(dirty.reshape(packed.shape)),
        torch.from_numpy(c["sel"]), torch.from_numpy(c["valid"]),
        torch.from_numpy(c["tile_start"]), torch.from_numpy(c["ntiles"]),
        mnt, 10, pair_bias=torch.from_numpy(pair_bias), hot=hot, tile=TILE)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("tile", [256, 512])
def test_plan_batch_and_fits_on_both_tile_sizes(tile, monkeypatch):
    """The shared plan stage over a PrunedLayout of either engine's tile:
    an allowlist marks exactly the disallowed live slots with
    _PAD_PENALTY; B x L <= QG takes invert_small with every leaf hot,
    larger batches the plan with HOT_LEAVES; fits flips at
    MAX_PLAN_WORK."""
    r = np.random.default_rng(tile)
    nl = 9
    leaf = np.repeat(np.arange(nl), r.integers(1, 3 * tile, nl))
    order, tile_start, ntiles, num_tiles = tps.build_layout_host(
        leaf, nl, seed=0, tile=tile)
    dpid = torch.from_numpy(order.astype(np.int32))
    bias = torch.where(dpid >= 0, 0.0, tps._PAD_PENALTY).reshape(
        num_tiles, tile, 1)
    layout = tps.PrunedLayout(
        torch.from_numpy(tile_start), torch.from_numpy(ntiles),
        int(ntiles.max()), num_tiles, dpid, bias, tile)
    allow = torch.from_numpy(r.random(len(leaf)) < 0.5)
    live = dpid >= 0
    for b, l in ((32, 4), (96, 5)):
        sel, valid = _selection(r, b, l, nl)
        args = (torch.from_numpy(sel), torch.from_numpy(valid))
        small = b * l <= tps.QG
        plan, got, hot = tps.plan_batch(layout, *args, allow)
        want = _torch_plan(sel, valid, tile_start, ntiles, small)
        assert all(torch.equal(g, w) for g, w in zip(plan, want))
        assert hot == (l if small else tps.HOT_LEAVES)
        added = (got - bias).reshape(-1)
        np.testing.assert_array_equal(
            added[live].numpy(), np.where(
                allow[dpid[live].long()].numpy(), 0.0,
                np.float32(tps._PAD_PENALTY)))
        assert tps.plan_batch(layout, *args)[1] is bias
    _, w_pad = tps.plan_capacities(96, 5, nl, num_tiles, int(ntiles.max()))
    monkeypatch.setattr(tps, "MAX_PLAN_WORK", w_pad)
    assert tps.fits(layout, 96, 5)
    monkeypatch.setattr(tps, "MAX_PLAN_WORK", w_pad - 1)
    assert not tps.fits(layout, 96, 5)


def test_build_layout_host_identical():
    r = np.random.default_rng(9)
    leaf = r.integers(0, 12, 3000)
    leaf[leaf == 5] = 4                                  # an empty leaf
    want = jps.build_layout_host(leaf, 12, seed=42, tile=TILE)
    got = tps.build_layout_host(leaf, 12, seed=42, tile=TILE)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
