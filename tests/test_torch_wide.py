"""Widths past the limits the port's kernels once had, on the CPU.

* K4 (the decode scorer): its plain version against the JAX package's
  ``score_work_xla_codes`` and its Pallas kernel in interpret mode at
  d_pad 208 (16 centers, 2 dimensions a block) and 224 (256 centers, 4),
  past the 144 that K4's shared memory once held.  Tolerance as in
  tests/test_torch_pruned_lut.py: unpacked values within rtol 2^-14 plus
  1e-5 (identity bits and summation order), identities equal on >= 99.9%
  of active survivors.
* K6 (the fused merge): its plain version bit-equal to the Pallas kernel
  in interpret mode at the widest row a scorer writes (16 tiles x 32
  survivors x 16 groups = 8192 columns, the reference's own VMEM bound).
* The widths the card once refused (K3's int8 LUT over 160 code blocks,
  K5's query tile over 384 dimensions) are served on a CUDA device as on
  the CPU: the factory's check passes them (checked without a card: the
  check reads the device, it does not touch it), and on the CPU the same
  settings build and search.  A no-tree reconstruct searcher still takes
  K5 only where its default search has enough 256-slot groups; a smaller
  index takes the dense scan.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scann_torch
from scann_torch.models import tree_ah
from scann_torch.ops import pruned_lut as tpl
from scann_torch.ops import pruned_scan as tps
from scann_tpu.ops import pruned_lut as jpl
from scann_tpu.ops import pruned_scan as jps
import torch_threads  # noqa: F401  (torch threads per xdist worker)

CUDA = torch.device("cuda")


def _codes_case(seed, cpb, dpb, b, l2, nl=4, nq=40, l=2):
    """A tree-AH decode-scoring problem of b code blocks in both
    packages' layouts, from numpy draws."""
    r = np.random.default_rng(seed)
    b_pad = -(-b // 8) * 8
    d_pad = b_pad * dpb
    ntiles = r.integers(1, 3, nl).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    num_tiles = int(ntiles.sum())
    sel = np.stack([r.choice(nl, l, replace=False)
                    for _ in range(nq)]).astype(np.int32)
    valid = r.random((nq, l)) < 0.9
    codes = r.integers(0, cpb, (num_tiles * 512, b)).astype(np.uint8)
    pad = r.random(num_tiles * 512) < 0.1
    codes[pad] = 255
    bias = np.where(pad, -1e30, 0.0).astype(np.float32).reshape(
        num_tiles, 512, 1)
    cb = (0.3 * r.standard_normal((b, cpb, dpb))).astype(np.float32)
    mean = np.zeros(d_pad, np.float32)
    if l2:
        mean[:b * dpb] = 0.1 * r.standard_normal(b * dpb)
    q = np.zeros((nq, d_pad), np.float32)
    q[:, :b * dpb] = r.standard_normal((nq, b * dpb))
    mnt = int(ntiles.max())
    g_pad, w_pad = tps.plan_capacities(nq, l, nl, num_tiles, mnt)
    targs = [torch.from_numpy(a) for a in (sel, valid, tile_start, ntiles)]
    tplan = tps.invert(*targs, mnt, g_pad, w_pad)
    jplan = jps.invert(*(jnp.asarray(a.numpy()) for a in targs), mnt, g_pad,
                       w_pad)
    codes3 = jpl.pack_codes_tiles(codes, num_tiles)
    got_args = (tplan, torch.from_numpy(q).to(torch.bfloat16)[
        tplan.qg_query.long()], torch.from_numpy(codes3),
        tpl.codes_table(torch.from_numpy(cb), b_pad), torch.from_numpy(mean),
        torch.from_numpy(bias))
    jargs = (jplan, jnp.asarray(q).astype(jnp.bfloat16)[jplan.qg_query],
             jnp.asarray(codes3), jnp.asarray(jpl.expand_codebook(
                 cb, d_pad, b_pad)), jnp.asarray(mean), jnp.asarray(bias))
    return got_args, jargs, d_pad


def _active(packed, plan, kpg):
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    act = np.asarray(plan.work_active).reshape(g_pad, mnt).astype(bool)
    p = np.asarray(packed).reshape(g_pad, 128, mnt, kpg * 16)
    return p.transpose(0, 2, 1, 3)[act]


def _close(got, want):
    gv = (got & ~np.int32(511)).view(np.float32).astype(np.float64)
    wv = (want & ~np.int32(511)).view(np.float32).astype(np.float64)
    live = wv > -1e20
    np.testing.assert_array_equal(gv > -1e20, live)
    np.testing.assert_allclose(gv[live], wv[live], rtol=2.0 ** -14,
                               atol=1e-5)
    assert np.mean((got & 511) == (want & 511)) >= 0.999


@pytest.mark.parametrize("l2", [False, True], ids=["dot", "l2"])
@pytest.mark.parametrize("cpb,dpb,b", [(16, 2, 100), (256, 4, 52)])
def test_k4_plain_version_close_to_jax_past_the_old_width(l2, cpb, dpb, b):
    got_args, jargs, d_pad = _codes_case(7 + cpb + l2, cpb, dpb, b, l2)
    assert d_pad > 144
    got = tpl.score_work_codes(*got_args, measure_l2=l2, kpg=8)
    g = _active(got.numpy(), got_args[0], 8)
    assert g.size
    for want in (jpl.score_work_xla_codes(*jargs, measure_l2=l2, kpg=8),
                 jpl.score_work_pallas_codes(*jargs, measure_l2=l2, kpg=8,
                                             interpret=True)):
        _close(g, _active(want, jargs[0], 8))


@pytest.mark.parametrize("k", [1, 32])
def test_k6_plain_version_bit_equal_to_pallas_at_the_widest_row(k):
    """w 8192 (the widest row, within the reference's VMEM bound), groups
    whose tile counts run from 0 to 16, value bits on a coarse grid."""
    r = np.random.default_rng(50 + k)
    g_pad, mnt, kpg, tile = 3, 16, 32, 512
    kgp = kpg * tile // 32
    w = mnt * kgp
    assert 2 * 128 * w * 4 <= jps._FUSED_VMEM_BUDGET
    scores = (r.integers(-8, 8, (g_pad, 128, w)) * 0.25).astype(np.float32)
    arg = (r.integers(0, 32, (g_pad, 128, mnt, 1, 16))
           + np.arange(kpg)[None, None, None, :, None]) % 32
    ident = ((np.arange(w) // kgp) << 5)[None, None, :] | arg.reshape(
        g_pad, 128, w)
    packed = ((scores.view(np.int32) & ~511) | ident).astype(np.int32)
    nt = np.array([0, 5, 16], np.int32)
    wm, wt = jps.merge_groups_pallas(jnp.asarray(packed), jnp.asarray(nt),
                                     kgp=kgp, tile=tile, k=k, interpret=True)
    gm, gt = tps.merge_groups(torch.from_numpy(packed), torch.from_numpy(nt),
                              kgp=kgp, tile=tile, k=k)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


def _config(d, lookup, tree, num_leaves=8, reorder=20, dpb=2):
    db = np.zeros((4, d), np.float32)
    b = scann_torch.builder(db, 10, "dot_product", device="cpu")
    if tree:
        b = b.tree(num_leaves=num_leaves, num_leaves_to_search=2,
                   training_sample_size=2000)
    c = b.score_ah(dpb, training_sample_size=2000).reorder(reorder) \
        .create_config()
    return dataclasses.replace(c, asymmetric_hash=dataclasses.replace(
        c.asymmetric_hash, lookup_type=lookup))


@pytest.mark.parametrize("d,lookup,tree,refused", [
    (320, "int8", True, False),        # b_pad 160: K3 once at 8 survivors
    (330, "int8", True, True),         # b_pad 168: once no survivor count
    (800, "int8", False, False),       # no tree: no K3
    (384, "reconstruct", False, False),
    (400, "reconstruct", False, True),  # every search a K5 scan over 512
    (800, "reconstruct", True, False),  # the pruned path is K2
    (800, "float32", True, False)])     # K4 serves any width
def test_check_supported_refuses_unserved_widths_on_cuda(d, lookup, tree,
                                                         refused):
    """Every width is served on a CUDA device, the ones the card once
    refused (``refused``) included, and so is autopilot (ROADMAP item
    17), the last setting that refused: its rewrite at this width passes
    the same check."""
    del refused
    config = _config(d, lookup, tree)
    tree_ah.check_supported(config)
    for dev in (torch.device("cpu"), CUDA):
        scann_torch.factory.check_supported(config, dev, d)
    from scann_torch.utils import autopilot
    auto = dataclasses.replace(
        config, autopilot=scann_torch.config.AutopilotConfig())
    for n in (100, 100_000):
        rewritten = autopilot.autopilot_rewrite(
            auto, np.broadcast_to(np.float32(0), (n, d)))
        scann_torch.factory.check_supported(rewritten, CUDA, d, n)


@pytest.mark.parametrize("rows,refused", [
    (18432, False),     # 72 groups of 256 slots: under 4 x 20, dense scan
    (18433, True),      # padded to 20480 slots: 80 groups, a K5 scan
    (20480, True),
    (10 ** 6, True)])
def test_no_tree_reconstruct_guard_follows_the_index_size(rows, refused):
    """A no-tree reconstruct searcher at 400 dimensions is served on a
    CUDA device at every size.  Its default search (20 candidates before
    reordering) is a K5 scan exactly where the card once refused it
    (``refused``), over the slots the layout pads the rows to; a smaller
    index takes the dense scan."""
    config = _config(400, "reconstruct", False)
    for dev in (torch.device("cpu"), CUDA):
        scann_torch.factory.check_supported(config, dev, 400, rows)
    slots = tree_ah._round_up(rows, tree_ah._slot_chunk(rows, True))
    assert tree_ah._takes_k5(slots, 20) == refused


def _data(n, d, seed=0):
    r = np.random.default_rng(seed)
    c = r.standard_normal((16, d))
    db = (c[r.integers(0, 16, n)] + 0.3 * r.standard_normal((n, d)))
    q = (c[r.integers(0, 16, 8)] + 0.3 * r.standard_normal((8, d)))
    return db.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("lookup,tree", [("int8", True),
                                         ("reconstruct", False)])
def test_cpu_builds_and_searches_the_widths_the_card_refuses(
        lookup, tree, tmp_path):
    """The CPU's plain versions serve these widths, which the card once
    refused and now serves too: the loader's check passes the index for a
    CUDA device, and reloaded on the CPU it returns the same results.  The
    no-tree index is large enough (8200 rows, padded to 40 groups of 256
    slots for 10 candidates) that every search is a K5 scan."""
    db, q = _data(2000 if tree else 8200, 400)
    config = _config(400, lookup, tree, reorder=20 if tree else 10)
    s = scann_torch.create_searcher(db, config, "cpu")
    idx, dist = s.search_batched(q)
    assert idx.shape == (8, 10) and (idx >= 0).all()
    assert np.isfinite(dist).all()
    if not tree:
        assert tree_ah._takes_k5(s._recon_rows.shape[0], 10)
    s.serialize(str(tmp_path))
    scann_torch.factory.check_supported(s.config, CUDA, 400, db.shape[0])
    idx2, dist2 = scann_torch.load_searcher(str(tmp_path),
                                            device="cpu").search_batched(q)
    np.testing.assert_array_equal(idx2, idx)
    np.testing.assert_array_equal(dist2, dist)


def test_k3_search_refuses_16_survivors_where_only_8_fit():
    """At b_pad 152 (d 304 at two dimensions a block) K3's LUT once fit a
    block at 8 survivors a group and not at 16; the kernel now streams
    the LUT and takes either.  A search whose budget asks for 16
    survivors a group and one that takes 8 both run."""
    db, q = _data(2000, 304)
    s = scann_torch.create_searcher(db, _config(304, "int8", True,
                                                reorder=100), "cpu")
    nl = s.partitioner.num_leaves
    assert tree_ah._survivors_per_group(100, s._num_slots, nl) == 16
    assert tree_ah._survivors_per_group(10, s._num_slots, nl) == 8
    for budget in (100, 10):
        idx, _ = s.search_batched(q, pre_reorder_num_neighbors=budget)
        assert idx.shape == (8, 10) and (idx >= 0).all()
