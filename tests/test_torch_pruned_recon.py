"""K2 (the pruned scorer over decoded bf16 rows) and the reconstruct-mode
layouts of the port against scann_tpu.

Scorer: the same numpy-seeded rows, bias plane, queries and leaf selections
go through ``scann_torch.ops.pruned_scan.score_work_torch`` (the plain
version of the CUDA kernel csrc/pruned_rows.cu), through the JAX package's
XLA twin ``score_work_xla`` and through its Pallas kernel in interpret
mode.  bf16 x bf16 products are exact in f32 but their sum depends on its
order, so on active work items the unpacked values agree within 2^-14
relative plus 1e-5 (the 9 identity bits cost up to 2^-15) and the packed
identities on >= 99.99% of live survivors.

Layouts: on an index built by the JAX package, the port rebuilds the
decoded rows of both layouts (tile-major pruned rows, full-scan rows in the
random slot order) from the serialized codes.  Slot order and tile tables
are equal; under dot product the bf16 rows are bit-equal and the bias
planes equal; under squared L2 the rows depend on the decoded mean, whose
last bits may move a bf16 rounding: the share of differing elements stays
under 1e-3 (0 seen) and the -||x_hat||^2 bias agrees to 1e-5 relative."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scann_torch
import scann_tpu
from scann_torch.ops import pruned_scan as tps
from scann_tpu.ops import pruned_scan as jps
import torch_threads  # noqa: F401  (torch threads per xdist worker)

RTOL, ATOL, MIN_ID = 2.0 ** -14, 1e-5, 0.9999


def _problem(seed=3, num_leaves=12, b=96, l=5, d=128, l2=False, d_live=100):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(100, 1200, num_leaves)
    leaf = np.repeat(np.arange(num_leaves), sizes).astype(np.int64)
    order, tile_start, ntiles, num_tiles = jps.build_layout_host(
        leaf, num_leaves, seed=0)
    live = order >= 0
    rows = np.zeros((num_tiles * jps.TILE, d), np.float32)
    rows[live] = 0.3 * rng.standard_normal((int(live.sum()), d))
    rows[:, d_live:] = 0.0                   # dims padded to d
    rows_bf = torch.from_numpy(rows).to(torch.bfloat16).reshape(
        num_tiles, jps.TILE, d)
    sq = (rows_bf.float() ** 2).sum(-1).reshape(-1).numpy()
    bias = np.where(live, -sq if l2 else 0.0, -1e30).astype(
        np.float32).reshape(num_tiles, jps.TILE, 1)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q[:, d_live:] = 0.0
    sel = np.stack([rng.choice(num_leaves, l, replace=False)
                    for _ in range(b)]).astype(np.int32)
    valid = rng.random((b, l)) < 0.9
    mnt = int(ntiles.max())
    g_pad, w_pad = jps.plan_capacities(b, l, num_leaves, num_tiles, mnt)
    return dict(rows=rows_bf, bias=bias, q=q, sel=sel, valid=valid,
                tile_start=tile_start, ntiles=ntiles, mnt=mnt, g_pad=g_pad,
                w_pad=w_pad)


def _torch_side(p, kpg, l2, fn=tps.score_work_torch):
    t = torch.from_numpy
    plan = tps.invert(t(p["sel"]), t(p["valid"]), t(p["tile_start"]),
                      t(p["ntiles"]), p["mnt"], p["g_pad"], p["w_pad"])
    qg = t(p["q"]).to(torch.bfloat16)[plan.qg_query.long()]
    out = fn(plan, qg, p["rows"], t(p["bias"]), measure_l2=l2, kpg=kpg)
    return plan, out


def _jax_side(p, kpg, l2, interpret):
    plan = jps.invert(jnp.asarray(p["sel"]), jnp.asarray(p["valid"]),
                      jnp.asarray(p["tile_start"]), jnp.asarray(p["ntiles"]),
                      p["mnt"], p["g_pad"], p["w_pad"])
    qg = jnp.take(jnp.asarray(p["q"], jnp.bfloat16), plan.qg_query, axis=0)
    rows = jnp.asarray(p["rows"].float().numpy(), jnp.bfloat16)
    bias = jnp.asarray(p["bias"])
    if interpret:
        out = jps.score_work_pallas(plan, qg, rows, bias, measure_l2=l2,
                                    interpret=True, kpg=kpg)
    else:
        out = jps.score_work_xla(plan, qg, rows, bias, measure_l2=l2,
                                 kpg=kpg)
    return np.array(out)


def _hold(plan, got, want, kpg):
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, tps.QG, mnt, kpg * tps.GP)
    a = got.reshape(act.shape)[act]
    b = torch.from_numpy(want).reshape(act.shape)[act]
    assert a.numel() > 10_000
    va, vb = tps._unpack(a)[0].double(), tps._unpack(b)[0].double()
    live = vb > -1e20
    assert torch.equal(va > -1e20, live)
    err = (va - vb).abs()[live]
    assert torch.all(err <= RTOL * vb.abs()[live] + ATOL), err.max()
    same = ((a & tps._ID_MASK) == (b & tps._ID_MASK))[live]
    assert same.double().mean() >= MIN_ID, same.double().mean()


@pytest.mark.parametrize("l2", [False, True], ids=["dot", "l2"])
@pytest.mark.parametrize("kpg", [8, 16])
@pytest.mark.parametrize("interpret", [False, True],
                         ids=["xla_twin", "pallas_interpret"])
def test_k2_plain_version_matches_jax(l2, kpg, interpret):
    p = _problem(seed=3 + kpg + l2, l2=l2)
    plan, got = _torch_side(p, kpg, l2)
    assert got.shape == (p["g_pad"], tps.QG, p["mnt"] * kpg * tps.GP)
    assert got.dtype == torch.int32
    _hold(plan, got, _jax_side(p, kpg, l2, interpret), kpg)


def test_k2_small_plan_matches_jax():
    """The invert_small plan (B * L <= 128: one group per pair)."""
    p = _problem(seed=9, b=16, l=4)
    t = torch.from_numpy
    plan = tps.invert_small(t(p["sel"]), t(p["valid"]), t(p["tile_start"]),
                            t(p["ntiles"]), p["mnt"])
    qg = t(p["q"]).to(torch.bfloat16)[plan.qg_query.long()]
    got = tps.score_work_torch(plan, qg, p["rows"], t(p["bias"]),
                               measure_l2=False)
    jplan = jps.invert_small(
        jnp.asarray(p["sel"]), jnp.asarray(p["valid"]),
        jnp.asarray(p["tile_start"]), jnp.asarray(p["ntiles"]), p["mnt"])
    jqg = jnp.take(jnp.asarray(p["q"], jnp.bfloat16), jplan.qg_query, axis=0)
    want = jps.score_work_xla(
        jplan, jqg, jnp.asarray(p["rows"].float().numpy(), jnp.bfloat16),
        jnp.asarray(p["bias"]), measure_l2=False)
    _hold(plan, got, np.array(want), tps.KPG)


def test_k2_wrapper_on_cpu_runs_the_plain_version_uncounted():
    p = _problem(seed=5, b=40, l=3)
    before = tps.launches
    plan, got = _torch_side(p, 8, False, fn=tps.score_work)
    _, want = _torch_side(p, 8, False)
    assert torch.equal(got, want)
    assert tps.launches == before        # only kernel launches count


def test_k2_plain_version_matches_jax_past_128_dims():
    """Rows of 200 live dimensions padded to 256, a width the card now
    serves (reconstruct mode's _recon_dim above 128)."""
    p = _problem(seed=11, d=256, d_live=200)
    plan, got = _torch_side(p, 8, False)
    _hold(plan, got, _jax_side(p, 8, False, interpret=False), 8)


def test_k2_shared_memory_rule():
    """A K2 block's shared memory (csrc/tile_mma.cuh) takes no d_pad, so
    d_pad 256 fits where it once did not: the dimension axis streams
    through a ring of 32-dimension chunks.  The staged survivors fit over
    the ring at every kpg the wrapper takes, so it is one size, within
    what an H100 block may use."""
    sizes = {tps.tile_smem_bytes("bf16", kpg)
             for kpg in range(1, tps.SUBP + 1)}
    assert sizes == {256 * 4 + 4 * (256 + 64) * 80}
    assert max(sizes) <= tps._SMEM_LIMIT


# ------------------------------------------------------- decoded layouts
def _data(n=6000, d=32, seed=3):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((300, d)).astype(np.float32)
    db = centers[r.integers(0, 300, n)] + 0.5 * r.standard_normal((n, d))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    return db.astype(np.float32)


def _recon_config(builder_fn, db, measure, tree, threshold=0.2, **kw):
    b = builder_fn(db, 10, measure, **kw)
    if tree:
        b = b.tree(num_leaves=32, num_leaves_to_search=6,
                   training_sample_size=4000)
    b = b.score_ah(2, anisotropic_quantization_threshold=threshold,
                   training_sample_size=4000).reorder(20)
    config = b.create_config()
    return dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type="reconstruct"))


def _bf16_bits(t):
    return t.contiguous().view(torch.int16).numpy()


def _jax_bf16_bits(a):
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
@pytest.mark.parametrize("tree", [True, False], ids=["tree", "no_tree"])
def test_decoded_layouts_equal_on_a_jax_built_index(measure, tree, tmp_path):
    db = _data()
    js = scann_tpu.create_searcher(
        db, _recon_config(scann_tpu.builder, db, measure, tree))
    js.serialize(str(tmp_path))
    ts = scann_torch.load_searcher(str(tmp_path), device="cpu")
    assert ts._recon_mode and ts._recon_dim == 128
    assert ts._chunk == js._chunk and ts._chunk % 2048 == 0
    np.testing.assert_array_equal(ts.index.slot_dpid.numpy(),
                                  np.asarray(js.index.slot_dpid))
    l2 = measure == "squared_l2"
    if l2:
        np.testing.assert_allclose(ts._recon_mean.numpy(),
                                   np.asarray(js._recon_mean), rtol=1e-5,
                                   atol=1e-7)
    else:
        assert ts._recon_mean is None and js._recon_mean is None

    def hold(rows_t, bias_t, rows_j, bias_j):
        a, b = _bf16_bits(rows_t), _jax_bf16_bits(rows_j)
        assert a.shape == b.shape
        if l2:
            assert (a != b).mean() <= 1e-3
        else:
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(bias_t.numpy().reshape(-1),
                                   np.asarray(bias_j).reshape(-1),
                                   rtol=1e-5, atol=1e-6)

    js._ensure_recon_rows()
    ts._ensure_recon_rows()
    hold(ts._recon_rows, ts._recon_bias, js._recon_rows, js._recon_bias)
    assert (ts._recon_rows is not None) and ts._recon_rows.shape[1] == 128
    if not tree:
        assert not ts._pruned_available and ts.partitioner is None
        return
    js._ensure_pruned()
    ts._ensure_pruned()
    hold(ts._p_rows, ts._p_bias, js._p_rows, js._p_bias)
    assert ts._p_bias.shape == (ts._p_num_tiles, tps.TILE, 1)
    for name in ("_p_dpid", "_p_tile_start", "_p_ntiles"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    assert ts._p_max_ntiles == js._p_max_ntiles


def test_port_built_layout_takes_the_same_random_slot_order():
    """The port's own build permutes the leaf-sorted slots with the numpy
    draw the JAX package uses, and aligns small indexes to 2048 slots."""
    db = _data(n=3000)
    ts = scann_torch.create_searcher(
        db, _recon_config(scann_torch.builder, db, "dot_product", True,
                          threshold=float("nan"), device="cpu"), "cpu")
    assert ts._chunk == 4096 and ts.index.slot_dpid.shape == (4096,)
    leaf = ts.datapoint_to_token[:, 0]
    order = np.argsort(leaf, kind="stable")
    order = order[np.random.default_rng(ts.config.seed).permutation(3000)]
    np.testing.assert_array_equal(ts._host["dpid"][:3000], order)
    np.testing.assert_array_equal(ts._host["leaf"][:3000], leaf[order])
    assert (ts._host["dpid"][3000:] == -1).all()
    assert ts.index.codes is None and ts._p_rows is None   # built on demand
