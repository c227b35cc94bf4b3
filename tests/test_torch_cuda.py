"""Tests of the port that need a CUDA card (marker ``cuda``): the K1-K6
CUDA kernels against their plain torch versions, the CUDA search paths
(tree-SQ, tree-AH in every lookup mode, SOAR's two-slot layout, the fused
merge, and every score_brute_force composition: brute force, Tree-X dense
leaves, tree-SQ + reorder) against the CPU plain path on the same index,
dedup and crowding on the card against the CPU, and the wrappers'
refusal of bad inputs.
They skip without a card.  On a machine with one (no JAX needed; the
repository's conftest imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerance of K1 and K4 against their plain versions: unpacked values
within rtol 2^-14 (identity perturbation plus summation order), packed
identities equal on >= 99.9% of active survivors; K4 at every width also
within the same bar of float64 scores rescored from its codes, and at raw
scale within 1.5x the plain version's float64 excess (as K1 and K2).  K3
at two dimensions per block: packed survivors bit-equal (exact products,
one rounded sum per LUT entry, exact integer sums).  K2 as K4 (values within 2^-14 relative
plus 1e-5, identities >= 99.99%).  K5: values within 1e-5 relative plus
1e-5, slot ids equal on >= 99.9% of groups, and where they differ the two
values within that tolerance of each other (a tie broken by summation
order).  K6: bit-equal on the rows of active groups (integer and compare
work only), and on every row at the widest row a scorer writes."""

import numpy as np
import pytest
import torch

import scann_torch
from scann_torch import _cuda
from scann_torch.ops import fused_scan
from scann_torch.ops import pruned_lut
from scann_torch.ops import pruned_scan as ps
from scann_torch.ops import pruned_sq
from scann_torch.tools import tile_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, seed, d=100, nl=40, b=300, l=6):
    r = np.random.default_rng(seed)
    ntiles = r.integers(1, 5, nl).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    num_tiles, d_pad = int(ntiles.sum()), -(-d // 8) * 8
    sel = np.stack([r.choice(nl, l, replace=False) for _ in range(b)])
    valid = r.random((b, l)) < 0.9
    g_pad, w_pad = ps.plan_capacities(b, l, nl, num_tiles,
                                      int(ntiles.max()))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    plan = ps.invert(t(sel.astype(np.int32)), t(valid), t(tile_start),
                     t(ntiles), int(ntiles.max()), g_pad, w_pad)
    rows = r.integers(-127, 128, (num_tiles, 256, d_pad)).astype(np.int8)
    rows[..., d:] = 0
    scale = r.uniform(1e-3, 1e-2, (num_tiles, 256, 1)).astype(np.float32)
    bias = (-r.uniform(0, 1, (num_tiles, 256, 1))).astype(np.float32)
    bias[r.random(bias.shape) < 0.1] = -1e30
    q = np.pad(r.standard_normal((b, d)).astype(np.float32),
               ((0, 0), (0, d_pad - d)))
    qg = t(q).to(torch.bfloat16)[plan.qg_query.long()]
    return plan, qg, t(rows), t(scale), t(bias)


def _hold_k1(plan, got, want, kpg):
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, 128, mnt, kpg * 8)
    a = got.reshape(act.shape)[act]
    b = want.reshape(act.shape)[act]
    assert a.numel()
    va, vb = ps._unpack(a)[0].double(), ps._unpack(b)[0].double()
    assert torch.all((va - vb).abs() <= 2.0 ** -14 * vb.abs() + 1e-6)
    assert ((a & 511) == (b & 511)).double().mean() >= 0.999


# d_pad 104 is no multiple of the kernel's 32-dimension chunk (the last
# chunk is zero-filled in shared memory); 384 and 768 are widths its shared
# memory once refused (above 296), on synthetic plans at the scale of an
# index of unit vectors.  The kernel is also held to float64 scores.
@pytest.mark.parametrize("d_pad", [104, 384, 768])
@pytest.mark.parametrize("measure_l2", [False, True])
@pytest.mark.parametrize("kpg", [4, 8])
def test_k1_kernel_matches_plain_version(cuda, measure_l2, kpg, d_pad):
    if d_pad == 104:
        case = _case(cuda, 1 + kpg + measure_l2)
    else:
        case = tile_cases.synthetic_case(
            "k1", d_pad, unit=True, measure_l2=measure_l2, seed=d_pad + kpg)
    plan, qg, rows, scale, bias = case
    assert rows.shape[-1] == d_pad
    before = pruned_sq.launches
    got = pruned_sq.score_work_sq(plan, qg, rows, scale, bias,
                                  measure_l2=measure_l2, kpg=kpg)
    assert pruned_sq.launches == before + 1
    want = pruned_sq.score_work_torch_sq(plan, qg, rows, scale, bias,
                                         measure_l2=measure_l2, kpg=kpg)
    torch.cuda.synchronize()
    _hold_k1(plan, got, want, kpg)
    assert tile_cases.exact_excess(case, got, kpg, measure_l2).max() \
        <= 1e-6


def test_k1_wrapper_rejects_bad_inputs(cuda):
    plan, qg, rows, scale, bias = _case(cuda, 9)
    with pytest.raises(ValueError, match="qg_rows"):
        pruned_sq.score_work_sq(plan, qg.float(), rows, scale, bias,
                                measure_l2=False)
    strided = torch.zeros(bias.shape[:2] + (2,), device=cuda)[..., :1]
    with pytest.raises(ValueError, match="contiguous"):
        pruned_sq.score_work_sq(plan, qg, rows, scale, strided,
                                measure_l2=False)


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_cuda_search_matches_cpu_plain_path(cuda, measure, tmp_path):
    r = np.random.default_rng(0)
    db = r.standard_normal((20000, 48)).astype(np.float32)
    q = r.standard_normal((256, 48)).astype(np.float32)
    s = (scann_torch.builder(db, 10, measure)
         .tree(num_leaves=32, num_leaves_to_search=4,
               training_sample_size=10000)
         .score_brute_force(quantize="int8").build())
    assert s.slot_rows.is_cuda
    before = pruned_sq.launches
    gi, gd = s.search_batched(q, leaves_to_search=4)
    assert pruned_sq.launches > before
    s.serialize(str(tmp_path))
    ci, cd = scann_torch.load_searcher(str(tmp_path), device="cpu"
                                       ).search_batched(q, leaves_to_search=4)
    assert np.mean(gi == ci) >= 0.999
    same = gi == ci
    np.testing.assert_allclose(gd[same], cd[same], rtol=1e-4, atol=1e-4)


def _ah_case(dev, seed, cpb, dpb, l2, b=50, nl=40, nq=300, l=6,
             max_tiles=3):
    """A tree-AH scoring problem, by default at the bench's block count (50
    blocks, b_pad 56), in the port's layout (d_pad = b_pad * dpb), with
    leaves of 1 to ``max_tiles`` tiles; the queries come ungathered (K3
    takes them so, K4 takes q[plan.qg_query])."""
    r = np.random.default_rng(seed)
    b_pad = -(-b // 8) * 8
    d_pad = b_pad * dpb
    ntiles = r.integers(1, max_tiles + 1, nl).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    num_tiles = int(ntiles.sum())
    sel = np.stack([r.choice(nl, l, replace=False) for _ in range(nq)])
    valid = r.random((nq, l)) < 0.9
    g_pad, w_pad = ps.plan_capacities(nq, l, nl, num_tiles,
                                      int(ntiles.max()))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    plan = ps.invert(t(sel.astype(np.int32)), t(valid), t(tile_start),
                     t(ntiles), int(ntiles.max()), g_pad, w_pad)
    codes = r.integers(0, cpb, (num_tiles * 512, b)).astype(np.uint8)
    pad_slot = r.random(num_tiles * 512) < 0.1
    bias = np.where(pad_slot, -1e30, 0.0).astype(np.float32).reshape(
        num_tiles, 512, 1)
    cb = (0.3 * r.standard_normal((b, cpb, dpb))).astype(np.float32)
    mean = np.zeros(d_pad, np.float32)
    if l2:
        mean[:b * dpb] = 0.1 * r.standard_normal(b * dpb)
    q = np.zeros((nq, d_pad), np.float32)
    q[:, :b * dpb] = r.standard_normal((nq, b * dpb))
    return (plan, t(q).to(torch.bfloat16), codes, pad_slot, t(cb), t(mean),
            t(bias), num_tiles)


def _active_pair(plan, got, want, kpg):
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, 128, mnt, kpg * 16)
    return got.reshape(act.shape)[act], want.reshape(act.shape)[act]


# b_pad 56 (the bench), and 168, 256 and 480 (GIST-960 at 2 dimensions a
# block): widths whose LUT the kernel's shared memory once refused (above
# 160 at 8 survivors a group, 144 at 16); at 168 and up the LUT streams
# through the ring in chunks of 32 blocks, copied again for every tile.
_K3_WIDTHS = [(l2, kpg, b, 3, 2) for b in (50, 168, 256, 480)
              for kpg in (8, 16) for l2 in (False, True)]


@pytest.mark.parametrize("measure_l2,kpg,b,max_tiles,dpb", _K3_WIDTHS + [
    # Every leaf one tile (one item a group), and leaves of up to 5 tiles
    # (groups with inactive items), at a resident and a streamed width.
    (False, 16, 50, 1, 2), (True, 8, 50, 5, 2), (True, 8, 200, 5, 2),
    # One dimension per block: the LUT build's general path (an entry is
    # one exact product, so bit-equality holds whatever the order).
    (True, 8, 50, 3, 1), (False, 16, 100, 3, 1)])
def test_k3_kernel_bit_equal_to_plain_version(cuda, measure_l2, kpg, b,
                                              max_tiles, dpb):
    plan, q, codes, pad, cb, mean, bias, nt = _ah_case(
        cuda, 20 + kpg + measure_l2 + b + max_tiles, 16, dpb, measure_l2,
        b=b, max_tiles=max_tiles)
    if max_tiles > 1:
        assert not plan.work_active.bool().all()
    codes3p = torch.as_tensor(pruned_lut.pack_codes_nibble(
        np.where(pad[:, None], 0, codes).astype(np.uint8), nt), device=cuda)
    cb_k, csq = pruned_lut.lut_tables(cb, mean, codes3p.shape[-1] * 2,
                                      measure_l2=measure_l2)
    before = pruned_lut.launches_lut
    got = pruned_lut.score_work_lut(plan, q, codes3p, cb_k, csq, bias,
                                    measure_l2=measure_l2, kpg=kpg)
    assert pruned_lut.launches_lut == before + 1
    want = pruned_lut.score_work_torch_lut(
        plan, q[plan.qg_query.long()], codes3p, cb_k, csq, bias,
        measure_l2=measure_l2, kpg=kpg)
    torch.cuda.synchronize()
    a, b = _active_pair(plan, got, want, kpg)
    assert a.numel() and torch.equal(a, b)


@pytest.mark.parametrize("measure_l2", [False, True])
@pytest.mark.parametrize("cpb,dpb,b,kpg", [(16, 2, 50, 8), (16, 2, 50, 16),
                                            (256, 4, 25, 8)])
def test_k4_kernel_matches_plain_version(cuda, measure_l2, cpb, dpb, b, kpg):
    plan, q, codes, pad, cb, mean, bias, nt = _ah_case(
        cuda, 40 + cpb + kpg + measure_l2, cpb, dpb, measure_l2, b=b)
    codes3 = torch.as_tensor(pruned_lut.pack_codes_tiles(
        np.where(pad[:, None], 255, codes).astype(np.uint8), nt),
        device=cuda)
    args = (plan, q[plan.qg_query.long()], codes3,
            pruned_lut.codes_table(cb, codes3.shape[-1]), mean, bias)
    before = pruned_lut.launches_codes
    got = pruned_lut.score_work_codes(*args, measure_l2=measure_l2, kpg=kpg)
    assert pruned_lut.launches_codes == before + 1
    want = pruned_lut.score_work_torch_codes(*args, measure_l2=measure_l2,
                                             kpg=kpg)
    torch.cuda.synchronize()
    a, b_ = _active_pair(plan, got, want, kpg)
    va, vb = ps._unpack(a)[0].double(), ps._unpack(b_)[0].double()
    assert torch.all((va - vb).abs() <= 2.0 ** -14 * vb.abs() + 1e-5)
    assert ((a & 511) == (b_ & 511)).double().mean() >= 0.999


def _hold_k4(case, got, want, kpg, measure_l2):
    """K4's bar against its plain version (values within 2^-14 relative
    plus 1e-5, identities equal on >= 99.9% of active survivors), and the
    same bar against float64 scores rescored from the codes."""
    a, b = _active_pair(case[0], got, want, kpg)
    va, vb = ps._unpack(a)[0].double(), ps._unpack(b)[0].double()
    assert a.numel()
    assert torch.all((va - vb).abs() <= 2.0 ** -14 * vb.abs() + 1e-5)
    assert ((a & 511) == (b & 511)).double().mean() >= 0.999
    assert tile_cases.exact_excess(case, got, kpg, measure_l2).max() <= 1e-5


# Widths past the 144 K4's shared memory once held (and 104 and the
# bench's 112, under it), 16 centers at 1 and 2 dimensions a block, 256 at
# 4, and 3 dimensions a block, a width that does not divide the kernel's
# 32-dimension chunk (a block straddles two chunks), on synthetic plans at
# the scale of an index of unit vectors.
@pytest.mark.parametrize("d,cpb,dpb", [
    (104, 16, 1), (112, 16, 2), (256, 16, 2), (384, 16, 2), (768, 16, 2),
    (256, 256, 4), (768, 256, 4), (120, 16, 3)])
@pytest.mark.parametrize("measure_l2", [False, True])
@pytest.mark.parametrize("kpg", [8, 16])
def test_k4_kernel_matches_plain_version_at_every_width(cuda, d, cpb, dpb,
                                                        measure_l2, kpg):
    case = tile_cases.synthetic_case("k4", d, unit=True,
                                     measure_l2=measure_l2, seed=d + kpg,
                                     cpb=cpb, dpb=dpb)
    assert case[1].shape[-1] == d
    before = pruned_lut.launches_codes
    got = tile_cases.score("k4", case, kpg, measure_l2)
    assert pruned_lut.launches_codes == before + 1
    want = tile_cases.plain("k4", case, kpg, measure_l2)
    torch.cuda.synchronize()
    _hold_k4(case, got, want, kpg, measure_l2)


def test_k3_k4_wrappers_reject_bad_inputs(cuda):
    plan, q, codes, pad, cb, mean, bias, nt = _ah_case(cuda, 7, 16, 2,
                                                       False)
    codes3 = torch.as_tensor(pruned_lut.pack_codes_tiles(codes, nt),
                             device=cuda)
    with pytest.raises(ValueError, match="qg_rows"):
        pruned_lut.score_work_codes(
            plan, q[plan.qg_query.long()].float(), codes3,
            pruned_lut.codes_table(cb, codes3.shape[-1]), mean, bias,
            measure_l2=False)
    codes3p = torch.as_tensor(pruned_lut.pack_codes_nibble(codes, nt),
                              device=cuda)
    cb_k, csq = pruned_lut.lut_tables(cb, mean, codes3.shape[-1],
                                      measure_l2=False)
    # K3 takes the batch's queries, not the gathered groups.
    with pytest.raises(ValueError, match="q_rows"):
        pruned_lut.score_work_lut(plan, q[plan.qg_query.long()], codes3p,
                                  cb_k, csq, bias, measure_l2=False)
    with pytest.raises(ValueError, match="q_rows"):
        pruned_lut.score_work_lut(plan, q.float(), codes3p, cb_k, csq, bias,
                                  measure_l2=False)


@pytest.mark.parametrize("measure,lookup,reorder", [
    ("dot_product", "int8", "float32"), ("squared_l2", "int8", "int8"),
    ("dot_product", "float32", "bfloat16"), ("squared_l2", "float32", None)])
def test_cuda_tree_ah_search_matches_cpu_plain_path(cuda, measure, lookup,
                                                    reorder, tmp_path):
    import dataclasses
    r = np.random.default_rng(0)
    db = r.standard_normal((20000, 48)).astype(np.float32)
    q = r.standard_normal((256, 48)).astype(np.float32)
    b = (scann_torch.builder(db, 10, measure)
         .tree(num_leaves=32, num_leaves_to_search=4,
               training_sample_size=10000)
         .score_ah(2, anisotropic_quantization_threshold=0.2,
                   training_sample_size=10000))
    if reorder is not None:
        b = b.reorder(30, quantize=reorder)
    config = b.create_config()
    config = dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type=lookup))
    s = scann_torch.create_searcher(db, config, "cuda")
    before = (pruned_lut.launches_lut, pruned_lut.launches_codes)
    gi, gd = s.search_batched(q, leaves_to_search=4)
    assert s._p_codes.is_cuda
    grew = (pruned_lut.launches_lut - before[0],
            pruned_lut.launches_codes - before[1])
    assert grew == ((1, 0) if lookup == "int8" else (0, 1))
    fi, _ = s.search_batched(q[:32], leaves_to_search=32)   # dense scan
    s.serialize(str(tmp_path))
    cpu = scann_torch.load_searcher(str(tmp_path), device="cpu")
    ci, cd = cpu.search_batched(q, leaves_to_search=4)
    found = (gi[:, :, None] == ci[:, None, :]).any(-1)
    assert found.mean() >= 0.999
    same = gi == ci
    np.testing.assert_allclose(gd[same], cd[same], rtol=1e-4, atol=1e-4)
    cfi, _ = cpu.search_batched(q[:32], leaves_to_search=32)
    assert (fi[:, :, None] == cfi[:, None, :]).any(-1).mean() >= 0.999


def _rows_case(dev, seed, d=100, nl=40, nq=300, l=6, l2=False):
    """A reconstruct-mode scoring problem: decoded bf16 rows padded to 128
    dimensions, the bias plane carrying -||x||^2 under squared L2."""
    r = np.random.default_rng(seed)
    d_pad = -(-d // 128) * 128
    ntiles = r.integers(1, 4, nl).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    num_tiles = int(ntiles.sum())
    sel = np.stack([r.choice(nl, l, replace=False) for _ in range(nq)])
    valid = r.random((nq, l)) < 0.9
    g_pad, w_pad = ps.plan_capacities(nq, l, nl, num_tiles,
                                      int(ntiles.max()))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    plan = ps.invert(t(sel.astype(np.int32)), t(valid), t(tile_start),
                     t(ntiles), int(ntiles.max()), g_pad, w_pad)
    rows = np.zeros((num_tiles, 512, d_pad), np.float32)
    rows[..., :d] = 0.3 * r.standard_normal((num_tiles, 512, d))
    pad_slot = r.random((num_tiles, 512)) < 0.1
    rows[pad_slot] = 0.0
    bias = -(rows ** 2).sum(-1) if l2 else np.zeros((num_tiles, 512))
    bias = np.where(pad_slot, -1e30, bias).astype(np.float32)[..., None]
    q = np.zeros((nq, d_pad), np.float32)
    q[:, :d] = r.standard_normal((nq, d))
    qg = t(q).to(torch.bfloat16)[plan.qg_query.long()]
    return (plan, qg, t(rows).to(torch.bfloat16), t(bias), t(tile_start),
            t(ntiles), t(sel.astype(np.int32)), t(valid))


def _hold_k2(plan, got, want, kpg):
    a, b = _active_pair(plan, got, want, kpg)
    va, vb = ps._unpack(a)[0].double(), ps._unpack(b)[0].double()
    assert a.numel()
    assert torch.all((va - vb).abs() <= 2.0 ** -14 * vb.abs() + 1e-5)
    assert ((a & 511) == (b & 511)).double().mean() >= 0.9999


# d_pad 256 and 384: widths the kernel's shared memory once refused (above
# 128), on synthetic plans at the scale of an index of unit vectors.  The
# kernel is also held to float64 scores.
@pytest.mark.parametrize("d_pad", [128, 256, 384])
@pytest.mark.parametrize("measure_l2", [False, True])
@pytest.mark.parametrize("kpg", [8, 16])
def test_k2_kernel_matches_plain_version(cuda, measure_l2, kpg, d_pad):
    if d_pad == 128:
        plan, qg, rows, bias = _rows_case(cuda, 60 + kpg + measure_l2,
                                          l2=measure_l2)[:4]
    else:
        plan, qg, rows, _, bias = tile_cases.synthetic_case(
            "k2", d_pad, unit=True, measure_l2=measure_l2, seed=d_pad + kpg)
    assert rows.shape[-1] == d_pad
    before = ps.launches
    got = ps.score_work(plan, qg, rows, bias, measure_l2=measure_l2, kpg=kpg)
    assert ps.launches == before + 1
    want = ps.score_work_torch(plan, qg, rows, bias, measure_l2=measure_l2,
                               kpg=kpg)
    torch.cuda.synchronize()
    _hold_k2(plan, got, want, kpg)
    assert tile_cases.exact_excess((plan, qg, rows, None, bias), got,
                                   kpg, measure_l2).max() <= 1e-5


# At raw scale (standard-normal queries, full-range rows) and the widest
# widths the plain version's own f32 error passes the bars' floors, so the
# kernels' sums are held to float64 relative to it.  A sum chained through
# the tensor core's accumulator misses this bar (tile_breakdown's "chained
# accumulator" variant, PERF.md).
@pytest.mark.parametrize("kernel,d_pad", tile_cases.RAW_CASES)
@pytest.mark.parametrize("measure_l2", [False, True])
def test_k1_k2_raw_scale_sums_hold_float64_as_the_plain_version(
        cuda, kernel, d_pad, measure_l2):
    got, plain = tile_cases.raw_excess(
        kernel, d_pad, measure_l2,
        lambda case: tile_cases.score(kernel, case, 8, measure_l2))
    assert plain > 0
    assert got <= tile_cases.RAW_EXCESS_RATIO * plain


def test_k2_wrapper_rejects_bad_inputs(cuda):
    plan, qg, rows, bias = _rows_case(cuda, 5)[:4]
    with pytest.raises(ValueError, match="rows3"):
        ps.score_work(plan, qg, rows.float(), bias, measure_l2=False)
    with pytest.raises(ValueError, match="tile 256"):
        ps.score_work(plan, qg, rows[:, :256].contiguous(), bias,
                      measure_l2=False)
    with pytest.raises(ValueError, match="kpg"):
        ps.score_work(plan, qg, rows, bias, measure_l2=False, kpg=33)


@pytest.mark.parametrize("lib,rows,kpg,dpb", [
    ("pruned_sq", "int8", 4, None), ("pruned_rows", "bf16", 8, None),
    ("pruned_rows", "bf16", 16, None), ("pruned_codes", "codes", 8, 2),
    ("pruned_codes", "codes", 16, 4), ("pruned_codes", "codes", 8, 3)])
def test_k1_k2_shared_memory_is_the_python_rule_at_every_width(
        cuda, lib, rows, kpg, dpb):
    """The C kernel's shared memory (K1, K2 and K4), as its occupancy
    export reports it, is ps.tile_smem_bytes at every d_pad."""
    for d_pad in (104, 128, 256, 768):
        shape = (d_pad, kpg) if dpb is None else (d_pad, dpb, kpg)
        assert _cuda.occupancy(lib, *shape)["smem_bytes"] == \
            ps.tile_smem_bytes(rows, kpg)


def _one_item_plan(dev, num_tiles):
    """One query, one leaf of one tile: a plan of a single work item."""
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    plan = ps.invert_small(t(np.array([[1]], np.int32)),
                           t(np.ones((1, 1), bool)),
                           t(np.arange(num_tiles, dtype=np.int32)),
                           t(np.ones(num_tiles, np.int32)), 1)
    assert plan.work_tile.shape == (1,) and int(plan.work_active[0]) == 1
    return plan


@pytest.mark.parametrize("kernel", ["k1", "k2", "k4"])
@pytest.mark.parametrize("measure_l2", [False, True])
def test_one_item_plan_matches_plain_version(cuda, kernel, measure_l2):
    r = np.random.default_rng(70 + measure_l2)
    tiles, d_pad = 3, 136 if kernel == "k1" else 256
    plan = _one_item_plan(cuda, tiles)
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    q = t(r.standard_normal((1, d_pad)).astype(np.float32))
    qg = q.to(torch.bfloat16)[plan.qg_query.long()]
    if kernel == "k4":
        b = d_pad // 2
        codes = r.integers(0, 16, (tiles * 512, b)).astype(np.uint8)
        cb = t((0.3 * r.standard_normal((b, 16, 2))).astype(np.float32))
        mean = t((0.1 * r.standard_normal(d_pad) * measure_l2).astype(
            np.float32))
        case = (plan, qg,
                t(pruned_lut.pack_codes_tiles(codes, tiles)),
                (pruned_lut.codes_table(cb, b), mean),
                t(np.zeros((tiles, 512, 1), np.float32)))
        got = tile_cases.score("k4", case, 8, measure_l2)
        want = tile_cases.plain("k4", case, 8, measure_l2)
        torch.cuda.synchronize()
        _hold_k4(case, got, want, 8, measure_l2)
    elif kernel == "k1":
        args = (plan, qg,
                t(r.integers(-127, 128, (tiles, 256, d_pad)).astype(np.int8)),
                t(r.uniform(1e-3, 1e-2, (tiles, 256, 1)).astype(np.float32)),
                t(-r.uniform(0, 1, (tiles, 256, 1)).astype(np.float32)))
        got = pruned_sq.score_work_sq(*args, measure_l2=measure_l2, kpg=4)
        want = pruned_sq.score_work_torch_sq(*args, measure_l2=measure_l2,
                                             kpg=4)
        torch.cuda.synchronize()
        _hold_k1(plan, got, want, 4)
    else:
        rows = t((0.3 * r.standard_normal((tiles, 512, d_pad))).astype(
            np.float32)).to(torch.bfloat16)
        bias = -(rows.float() ** 2).sum(-1, keepdim=True) if measure_l2 \
            else torch.zeros((tiles, 512, 1), device=cuda)
        args = (plan, qg, rows, bias.contiguous())
        got = ps.score_work(*args, measure_l2=measure_l2, kpg=8)
        want = ps.score_work_torch(*args, measure_l2=measure_l2, kpg=8)
        torch.cuda.synchronize()
        _hold_k2(plan, got, want, 8)


@pytest.mark.parametrize("kernel,kpg", [("k1", 4), ("k1", 8), ("k2", 8),
                                        ("k2", 16), ("k4", 8), ("k4", 16)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_exact_tie_groups_take_the_plain_versions_identities(cuda, kernel,
                                                             kpg, sign):
    """Every slot of a group holds the same row, scale and bias, with
    small integers, so every sum is exact in any order and the whole group
    ties: the packed identities alone order it, as in _group_top_packed
    (the larger packed float wins: the higher slot above zero, the lower
    below), and the kernel keeps the plain version's survivors bit for
    bit.  K4: the same with one code row a group over a codebook of small
    integers (d_pad 208)."""
    r = np.random.default_rng(80 + kpg + (sign > 0))
    tile = 256 if kernel == "k1" else 512
    d_pad, nl, nq, l = 208 if kernel == "k4" else 200, 12, 200, 4
    ntiles = r.integers(1, 3, nl).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    num_tiles = int(ntiles.sum())
    sel = np.stack([r.choice(nl, l, replace=False) for _ in range(nq)])
    g_pad, w_pad = ps.plan_capacities(nq, l, nl, num_tiles,
                                      int(ntiles.max()))
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    plan = ps.invert(t(sel.astype(np.int32)), t(np.ones((nq, l), bool)),
                     t(tile_start), t(ntiles), int(ntiles.max()), g_pad,
                     w_pad)
    groups = num_tiles * tile // 32
    rows = np.repeat(r.integers(-4, 5, (groups, 1, d_pad)), 32, axis=1)
    rows = rows.reshape(num_tiles, tile, d_pad)
    # |dot| <= 208 * 4 * 2: the bias fixes every score's sign.
    bias = np.repeat(sign * r.integers(2000, 3000, (groups, 1)), 32, axis=1)
    bias = bias.reshape(num_tiles, tile, 1).astype(np.float32)
    q = r.integers(-2, 3, (nq, d_pad)).astype(np.float32)
    qg = t(q).to(torch.bfloat16)[plan.qg_query.long()]
    if kernel == "k4":
        b = d_pad // 2
        codes = np.repeat(r.integers(0, 16, (groups, 1, b)), 32, axis=1)
        codes3 = pruned_lut.pack_codes_tiles(
            codes.reshape(-1, b).astype(np.uint8), num_tiles)
        cb = t(r.integers(-4, 5, (b, 16, 2)).astype(np.float32))
        args = (plan, qg, t(codes3), pruned_lut.codes_table(cb, b),
                t(np.zeros(d_pad, np.float32)), t(bias))
        got = pruned_lut.score_work_codes(*args, measure_l2=False, kpg=kpg)
        want = pruned_lut.score_work_torch_codes(*args, measure_l2=False,
                                                 kpg=kpg)
    elif kernel == "k1":
        args = (plan, qg, t(rows.astype(np.int8)),
                t(np.full((num_tiles, tile, 1), 0.25, np.float32)), t(bias))
        got = pruned_sq.score_work_sq(*args, measure_l2=False, kpg=kpg)
        want = pruned_sq.score_work_torch_sq(*args, measure_l2=False,
                                             kpg=kpg)
    else:
        args = (plan, qg, t(rows.astype(np.float32)).to(torch.bfloat16),
                t(bias))
        got = ps.score_work(*args, measure_l2=False, kpg=kpg)
        want = ps.score_work_torch(*args, measure_l2=False, kpg=kpg)
    torch.cuda.synchronize()
    seg = kpg * tile // 32
    mnt = plan.work_tile.shape[0] // g_pad
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, 128, mnt, seg)
    a = got.reshape(act.shape)[act]
    b = want.reshape(act.shape)[act]
    assert a.numel() and torch.equal(a, b)
    # Pass p of a group holds slot 31 - p above zero, slot p below.
    p = (torch.arange(seg, device=cuda) // (tile // 32)).expand(
        act.shape)[act]
    assert torch.equal(a & 31, torch.where(ps._unpack(a)[0] > 0, 31 - p, p))


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_cuda_reconstruct_search_over_128_dims_goes_through_k2(cuda, measure,
                                                               tmp_path):
    """A reconstruct index of 200 dimensions (decoded rows padded to 256)
    searches its pruned path through K2 on the card and returns what the
    CPU plain path returns on the same index."""
    import dataclasses
    r = np.random.default_rng(2)
    db = r.standard_normal((20000, 200)).astype(np.float32)
    q = r.standard_normal((200, 200)).astype(np.float32)
    config = (scann_torch.builder(db, 10, measure)
              .tree(num_leaves=32, num_leaves_to_search=4,
                    training_sample_size=10000)
              .score_ah(2, anisotropic_quantization_threshold=0.2,
                        training_sample_size=10000)
              .reorder(20).create_config())
    config = dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type="reconstruct"))
    s = scann_torch.create_searcher(db, config, "cuda")
    assert s._recon_dim == 256
    before = ps.launches
    gi, gd = s.search_batched(q, leaves_to_search=4)
    assert ps.launches == before + 1
    s.serialize(str(tmp_path))
    ci, cd = scann_torch.load_searcher(str(tmp_path), device="cpu"
                                       ).search_batched(q, leaves_to_search=4)
    assert (gi[:, :, None] == ci[:, None, :]).any(-1).mean() >= 0.999
    same = gi == ci
    np.testing.assert_allclose(gd[same], cd[same], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_cuda_float32_lookup_search_over_144_dims_goes_through_k4(
        cuda, measure, tmp_path):
    """A float32-lookup tree-AH index of 200 dimensions (100 code blocks,
    d_pad 208, past the 144 K4's shared memory once held) searches its
    pruned path through K4 on the card and returns what the CPU plain path
    returns on the same index."""
    import dataclasses
    r = np.random.default_rng(3)
    db = r.standard_normal((20000, 200)).astype(np.float32)
    q = r.standard_normal((200, 200)).astype(np.float32)
    config = (scann_torch.builder(db, 10, measure)
              .tree(num_leaves=32, num_leaves_to_search=4,
                    training_sample_size=10000)
              .score_ah(2, anisotropic_quantization_threshold=0.2,
                        training_sample_size=10000)
              .reorder(20).create_config())
    config = dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type="float32"))
    s = scann_torch.create_searcher(db, config, "cuda")
    before = pruned_lut.launches_codes
    gi, gd = s.search_batched(q, leaves_to_search=4)
    assert pruned_lut.launches_codes == before + 1
    assert s._p_mean.shape[0] == 208
    s.serialize(str(tmp_path))
    ci, cd = scann_torch.load_searcher(str(tmp_path), device="cpu"
                                       ).search_batched(q, leaves_to_search=4)
    assert (gi[:, :, None] == ci[:, None, :]).any(-1).mean() >= 0.999
    same = gi == ci
    np.testing.assert_allclose(gd[same], cd[same], rtol=1e-4, atol=1e-4)


def test_cuda_wide_indexes_search_through_k3_and_k5(cuda, tmp_path):
    """The indexes the card once refused at 400 dimensions (int8 lookup
    over 200 code blocks, over K3's old 160; a reconstruct searcher
    without a tree, every search a K5 scan, over K5's old 384) build and
    search on the card through K3 and K5, and agree with the CPU plain
    path on the same index.  The tree reconstruct index also takes K2 on
    its pruned search and K5 on its full scan."""
    import dataclasses
    r = np.random.default_rng(4)
    db = r.standard_normal((30000, 400)).astype(np.float32)
    q = r.standard_normal((200, 400)).astype(np.float32)

    def config(lookup, tree):
        b = scann_torch.builder(db, 10, "dot_product")
        if tree:
            b = b.tree(num_leaves=32, num_leaves_to_search=4,
                       training_sample_size=10000)
        c = b.score_ah(2, training_sample_size=10000).reorder(20) \
            .create_config()
        return dataclasses.replace(c, asymmetric_hash=dataclasses.replace(
            c.asymmetric_hash, lookup_type=lookup))

    def counts():
        return (pruned_lut.launches_lut, fused_scan.launches, ps.launches)

    for i, (lookup, tree, leaves, grew) in enumerate((
            ("int8", True, 4, (1, 0, 0)),
            ("reconstruct", False, None, (0, 1, 0)),
            ("reconstruct", True, 4, (0, 0, 1)),
            ("reconstruct", True, "all", (0, 1, 0)))):
        if i < 3:
            s = scann_torch.create_searcher(db, config(lookup, tree),
                                            "cuda")
            s.serialize(str(tmp_path / str(i)))
            cpu = scann_torch.load_searcher(str(tmp_path / str(i)),
                                            device="cpu")
        kw = {} if leaves is None else dict(leaves_to_search=(
            s.partitioner.num_leaves if leaves == "all" else leaves))
        before = counts()
        gi, gd = s.search_batched(q, **kw)
        assert tuple(a - b for a, b in zip(counts(), before)) == grew
        ci, cd = cpu.search_batched(q, **kw)
        # Random 400-dimension rows make uneven leaves: 4 of them may hold
        # fewer than 10 rows for some queries (the CPU path alike).
        assert (gi >= 0).mean() > 0.5
        assert (gi[:, :, None] == ci[:, None, :]).any(-1).mean() >= 0.99
        same = gi == ci
        np.testing.assert_allclose(gd[same], cd[same], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("measure_l2,nq,s,d,dups", [
    (False, 512, 8192, 128, False), (True, 300, 6144, 128, False),
    (False, 64, 4096, 256, False), (True, 1, 2048, 128, False),
    # A batch one query over the 128-query tile, on one 2048-slot block.
    (False, 129, 2048, 128, False),
    # 256 dimensions with a batch that is not a multiple of the tile.
    (True, 257, 4096, 256, False),
    # Every group made of 16 distinct rows repeated at random places, so
    # nearly every group maximum is an exact tie: the first slot must win,
    # dot and L2 (with padded slots).
    (False, 300, 4096, 128, True), (True, 200, 6144, 128, True),
    # Widths the kernel's shared memory once refused (above 384): the
    # query tile streams through the ring beside the rows.  960 is
    # GIST-960's width.
    (True, 300, 4096, 448, False), (False, 257, 4096, 768, False),
    (True, 200, 4096, 960, False), (False, 300, 4096, 960, True)])
def test_k5_kernel_matches_plain_version(cuda, measure_l2, nq, s, d, dups):
    r = np.random.default_rng(nq + s)
    rows = r.standard_normal((s, d)).astype(np.float32)
    src = np.arange(s)        # the row each slot is a copy of
    if dups:
        for g0 in range(0, s, 256):
            src[g0:g0 + 256] = g0 + r.integers(0, 16, 256)
        rows = rows[src]
    live = 100 if d <= 256 else d - 40   # dimensions with data
    rows[:, live:] = 0.0
    valid = r.random(s) < 0.9
    rows[~valid] = 0.0
    # Live slots whose row is also at another live slot of the group.
    is_dup = np.zeros(s, bool)
    for g0 in range(0, s, 256) if dups else ():
        ids, ok = src[g0:g0 + 256] - g0, valid[g0:g0 + 256]
        is_dup[g0:g0 + 256] = ok & (np.bincount(ids[ok], minlength=256)[ids]
                                    > 1)
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    rows_bf = t(rows).to(torch.bfloat16)
    sq = (rows_bf.float() ** 2).sum(-1).cpu().numpy()
    bias = t(fused_scan.build_bias(valid, sq if measure_l2 else None))
    q = r.standard_normal((nq, d)).astype(np.float32)
    q[:, live:] = 0.0
    q_bf = t(q).to(torch.bfloat16)
    before = fused_scan.launches
    gv, gi = fused_scan.fused_scan_groupmax(q_bf, rows_bf, bias,
                                            measure_l2=measure_l2)
    assert fused_scan.launches == before + 1
    wv, wi = fused_scan.fused_scan_groupmax_torch(q_bf, rows_bf, bias,
                                                  measure_l2=measure_l2)
    torch.cuda.synchronize()
    assert gv.shape == wv.shape == (nq, s // 256) and gi.dtype == torch.int32
    tol = 1e-5 * wv.abs() + 1e-5
    assert torch.all((gv - wv).abs() <= tol)
    same = gi == wi
    assert same.double().mean() >= 0.999
    # A differing slot is a tie up to summation order: the plain scores of
    # both slots agree within the tolerance.
    sim = (2.0 if measure_l2 else 1.0) * (
        q_bf.float() @ rows_bf.float().T) + bias[None, :]
    alt = torch.gather(sim, 1, gi.long())
    assert torch.all((alt - wv).abs()[~same] <= tol[~same])
    if dups:
        # Where the plain maximum sits on a duplicated row, the kernel
        # names the same (first) slot: duplicates score bit-equal.
        dup_win = t(is_dup)[wi.long()]
        assert dup_win.double().mean() > 0.9
        assert torch.equal(gi[dup_win], wi[dup_win])


def test_k5_wrapper_rejects_bad_inputs(cuda):
    rows = torch.zeros((2048, 128), dtype=torch.bfloat16, device=cuda)
    bias = torch.zeros((2048,), device=cuda)
    q = torch.zeros((8, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported shapes"):
        fused_scan.fused_scan_groupmax(q, rows[:1000], bias[:1000])
    with pytest.raises(ValueError, match="queries"):
        fused_scan.fused_scan_groupmax(q.float(), rows, bias)


@pytest.mark.parametrize("tile,kpg,k", [(512, 8, 30), (512, 16, 10),
                                        (256, 4, 10), (512, 8, 1)])
def test_k6_kernel_bit_equal_to_plain_version(cuda, tile, kpg, k):
    """Packed rows as a scorer writes them (random scores with identities
    packed, many exact ties on the value bits, NaN in inactive segments);
    the kernel equals the plain version on every row of an active group."""
    r = np.random.default_rng(tile + kpg + k)
    nl, nq, l = 40, 300, 6
    ntiles = r.integers(1, 4, nl).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    sel = np.stack([r.choice(nl, l, replace=False) for _ in range(nq)])
    mnt = int(ntiles.max())
    g_pad, w_pad = ps.plan_capacities(nq, l, nl, int(ntiles.sum()), mnt)
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    plan = ps.invert(t(sel.astype(np.int32)),
                     t(np.ones((nq, l), bool)), t(tile_start), t(ntiles),
                     mnt, g_pad, w_pad)
    gp = tile // 32
    kgp = kpg * gp
    w = mnt * kgp
    # Few distinct values, so the 23 value bits tie often.
    scores = r.integers(-8, 8, (g_pad, 128, w)).astype(np.float32) * 0.25
    scores[r.random(scores.shape) < 0.05] = -1e30
    bits = scores.view(np.int32) & ~511
    # Identities as a scorer packs them: the kpg survivors of one (tile,
    # group) are distinct slots.
    col = np.arange(w)
    first = r.integers(0, 32, (g_pad, 128, mnt, 1, gp))
    arg = (first + np.arange(kpg)[None, None, None, :, None]) % 32
    ident = ((col // kgp) << 5)[None, None, :] | arg.reshape(g_pad, 128, w)
    packed = t((bits | ident).astype(np.int32))
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, 128, mnt, kgp).reshape(g_pad, 128, w)
    packed = torch.where(act, packed, torch.tensor(
        np.float32("nan").view(np.int32).item(), device=cuda,
        dtype=torch.int32)).contiguous()
    qg_nt = t(ntiles)[plan.qg_leaf.long()].contiguous()
    before = ps.launches_merge
    mb, ts = ps.merge_groups(packed, qg_nt, kgp=kgp, tile=tile, k=k)
    assert ps.launches_merge == before + 1
    wmb, wts = ps.merge_groups_torch(packed, qg_nt, kgp=kgp, tile=tile, k=k)
    torch.cuda.synchronize()
    live = plan.work_active.reshape(g_pad, mnt)[:, 0] == 1
    assert live.any()
    assert torch.equal(mb[live], wmb[live])
    assert torch.equal(ts[live], wts[live])


@pytest.mark.parametrize("k", [1, 32])
def test_k6_kernel_bit_equal_at_the_widest_row(cuda, k):
    """The widest row a scorer writes (16 tiles of 512 slots at 32
    survivors a group: w 8192, which the wide-row kernel serves by
    rescanning its columns) on groups whose tile counts run from 0
    (all-dead rows) to 16 (nt < mnt on most), with the value bits on a
    coarse grid (tie-heavy): bit-equal to the plain version on every
    row."""
    r = np.random.default_rng(90 + k)
    g_pad, mnt, kpg, tile = 17, 16, 32, 512
    gp = tile // 32
    kgp = kpg * gp
    w = mnt * kgp
    scores = (r.integers(-8, 8, (g_pad, 128, w)) * 0.25).astype(np.float32)
    scores[r.random(scores.shape) < 0.05] = -1e30
    col = np.arange(w)
    first = r.integers(0, 32, (g_pad, 128, mnt, 1, gp))
    arg = (first + np.arange(kpg)[None, None, None, :, None]) % 32
    ident = ((col // kgp) << 5)[None, None, :] | arg.reshape(g_pad, 128, w)
    packed = torch.as_tensor(
        ((scores.view(np.int32) & ~511) | ident).astype(np.int32),
        device=cuda)
    qg_nt = torch.arange(g_pad, dtype=torch.int32, device=cuda)
    before = ps.launches_merge
    mb, ts = ps.merge_groups(packed, qg_nt, kgp=kgp, tile=tile, k=k)
    assert ps.launches_merge == before + 1
    wmb, wts = ps.merge_groups_torch(packed, qg_nt, kgp=kgp, tile=tile, k=k)
    torch.cuda.synchronize()
    assert torch.equal(mb, wmb) and torch.equal(ts, wts)


@pytest.mark.parametrize("mnt", [2, 4])
def test_k6_kernel_orders_negative_zero_below_positive_zero(cuda, mnt):
    """The one key K6 orders apart from the plain version: -0.0 (a score of
    exactly -0.0 with identity bits zero) sits just below +0.0 in the
    kernel's order-preserving image, where the plain version's float
    compare calls them equal.  With both in a row the kernel takes +0.0,
    then -0.0, one a pass; the plain version takes the zeros of the
    largest tile first, both at once where they share it.  Every later
    pass agrees, and so does every row with only one sign of zero.  Rows
    of 256 columns take the direct kernel, of 512 the rescanning one."""
    r = np.random.default_rng(mnt)
    tile, kpg, k = 512, 8, 10
    gp = tile // 32
    kgp = kpg * gp
    w = mnt * kgp
    scores = -(1.0 + r.random((1, 128, w))).astype(np.float32)
    bits = (scores.view(np.int32) & ~511) | r.integers(0, 512, (1, 128, w))
    neg0 = np.int32(-2 ** 31)          # -0.0, identity bits zero
    # Columns 0 (tile 0), gp (tile 0) and kgp (tile 1) are group 0 of
    # their tile, so their identity bits are zero where the packed low
    # bits are.
    bits[0, 0, [0, kgp]] = [0, neg0]   # +0.0 tile 0, -0.0 tile 1
    bits[0, 1, [0, gp]] = [0, neg0]    # +0.0 and -0.0, both tile 0
    bits[0, 2, kgp] = neg0             # -0.0 alone
    bits[0, 3, 0] = 0                  # +0.0 alone
    packed = torch.as_tensor(bits.astype(np.int32), device=cuda)
    qg_nt = torch.full((1,), mnt, dtype=torch.int32, device=cuda)
    mb, ts = ps.merge_groups(packed, qg_nt, kgp=kgp, tile=tile, k=k)
    wmb, wts = ps.merge_groups_torch(packed, qg_nt, kgp=kgp, tile=tile, k=k)
    mb, ts, wmb, wts = (x[0].cpu().numpy() for x in (mb, ts, wmb, wts))
    np.testing.assert_array_equal(mb[2:], wmb[2:])
    np.testing.assert_array_equal(ts[2:], wts[2:])
    assert mb[2, 0] == neg0 and mb[3, 0] == 0
    # Kernel: +0.0 then -0.0, each a pass.
    for row, t_neg in ((0, 1), (1, 0)):
        assert list(mb[row, :2]) == [0, neg0]
        assert list(ts[row, :2]) == [0, t_neg]
    # Plain: row 0 takes tile 1's zero, then tile 0's; from pass 2 on the
    # two agree.
    assert list(wts[0, :2]) == [1, 0] and wmb[0, 1] == 0
    np.testing.assert_array_equal(mb[0, 2:], wmb[0, 2:])
    np.testing.assert_array_equal(ts[0, 2:], wts[0, 2:])
    # Plain: row 1 takes both zeros of tile 0 in one pass, so it runs one
    # pass ahead of the kernel.
    assert wts[1, 0] == 0 and wmb[1, 0] in (0, neg0)
    np.testing.assert_array_equal(mb[1, 2:], wmb[1, 1:-1])
    np.testing.assert_array_equal(ts[1, 2:], wts[1, 1:-1])


@pytest.mark.parametrize("measure,tree", [
    ("dot_product", True), ("squared_l2", True), ("dot_product", False),
    ("squared_l2", False)])
def test_cuda_reconstruct_search_matches_cpu_plain_path(cuda, measure, tree,
                                                        tmp_path):
    import dataclasses
    r = np.random.default_rng(0)
    db = r.standard_normal((30000, 48)).astype(np.float32)
    q = r.standard_normal((200, 48)).astype(np.float32)
    b = scann_torch.builder(db, 10, measure)
    if tree:
        b = b.tree(num_leaves=32, num_leaves_to_search=4,
                   training_sample_size=10000)
    b = b.score_ah(2, anisotropic_quantization_threshold=0.2,
                   training_sample_size=10000).reorder(20)
    config = b.create_config()
    config = dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type="reconstruct"))
    s = scann_torch.create_searcher(db, config, "cuda")
    s.serialize(str(tmp_path))
    cpu = scann_torch.load_searcher(str(tmp_path), device="cpu")
    searches = [dict(leaves_to_search=4), dict(leaves_to_search=32)] \
        if tree else [dict()]
    allow = np.zeros(len(db), bool)
    allow[::2] = True
    searches.append(dict(restrict_allowlist=allow, **searches[-1]))
    for kw in searches:
        before = (ps.launches, fused_scan.launches)
        gi, gd = s.search_batched(q, **kw)
        grew = (ps.launches - before[0], fused_scan.launches - before[1])
        pruned = kw.get("leaves_to_search") == 4
        fused = not pruned and "restrict_allowlist" not in kw
        assert grew == (int(pruned), int(fused)), (kw.keys(), grew)
        ci, cd = cpu.search_batched(q, **kw)
        found = (gi[:, :, None] == ci[:, None, :]).any(-1)
        assert found.mean() >= 0.999
        same = gi == ci
        np.testing.assert_allclose(gd[same], cd[same], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("engine", ["tree_sq", "tree_ah_int8",
                                    "tree_ah_reconstruct"])
def test_cuda_fused_merge_matches_stratified_merge(cuda, engine,
                                                   monkeypatch):
    """With SCANN_TORCH_FUSED_MERGE=1 the search launches K6 and returns
    what the stratified merge returns (the fused selection is exact; the
    stratified one keeps every hot leaf's survivors and one per group of
    the cold leaves, so a rare cold candidate may differ)."""
    import dataclasses
    r = np.random.default_rng(1)
    db = r.standard_normal((30000, 48)).astype(np.float32)
    q = r.standard_normal((300, 48)).astype(np.float32)
    b = scann_torch.builder(db, 10, "dot_product").tree(
        num_leaves=32, num_leaves_to_search=6, training_sample_size=10000)
    if engine == "tree_sq":
        s = b.score_brute_force(quantize="int8").build()
    else:
        config = b.score_ah(
            2, anisotropic_quantization_threshold=0.2,
            training_sample_size=10000).reorder(30).create_config()
        lookup = engine.rsplit("_", 1)[1]
        config = dataclasses.replace(
            config, asymmetric_hash=dataclasses.replace(
                config.asymmetric_hash, lookup_type=lookup))
        s = scann_torch.create_searcher(db, config, "cuda")
    monkeypatch.delenv("SCANN_TORCH_FUSED_MERGE", raising=False)
    before = ps.launches_merge
    wi, wd = s.search_batched(q)
    assert ps.launches_merge == before
    monkeypatch.setenv("SCANN_TORCH_FUSED_MERGE", "1")
    gi, gd = s.search_batched(q)
    assert ps.launches_merge == before + 1
    found = (gi[:, :, None] == wi[:, None, :]).any(-1)
    assert found.mean() >= 0.995
    same = gi == wi
    np.testing.assert_allclose(gd[same], wd[same], rtol=1e-5, atol=1e-6)


# The score_brute_force compositions (plain torch on both devices):
# (measure, brute-force quantize, tree leaves or None, reorder quantize,
# reorder residual).
_COMPOSITIONS = {
    "bf_f32_dot": ("dot_product", "float32", None, None, True),
    "bf_int8_l2": ("squared_l2", "int8", None, None, True),
    "bf_bf16_cosine": ("cosine", "bfloat16", None, None, True),
    "bf_l1": ("l1", "float32", None, None, True),
    "bf_bf16_reorder_int8": ("dot_product", "bfloat16", None, "int8", True),
    "tree_x_f32_l2": ("squared_l2", "float32", 32, None, True),
    "tree_x_bf16_dot": ("dot_product", "bfloat16", 32, None, True),
    "tree_x_single_leaf": ("squared_l2", "int8", 1, None, True),
    "tree_sq_reorder_f32_l2": ("squared_l2", "int8", 32, "float32", True),
    "tree_sq_reorder_bf16": ("dot_product", "int8", 32, "bfloat16", True),
    "tree_sq_reorder_int8": ("dot_product", "int8", 32, "int8", True),
    "tree_sq_reorder_int8_raw": ("squared_l2", "int8", 32, "int8", False),
}


@pytest.mark.parametrize("name", sorted(_COMPOSITIONS))
def test_cuda_composition_matches_cpu_plain_path(cuda, name, tmp_path):
    """Each score_brute_force composition built on the card returns what
    the same index, serialized and loaded on the CPU, returns: >= 99.9% of
    the top-10 ids found in the CPU's top 10, distances within 1e-4
    relative (squared L2 relative to |d| + ||q||^2 + ||x||^2).  Tree-SQ
    points launch K1."""
    import dataclasses
    measure, quantize, leaves, reorder, residual = _COMPOSITIONS[name]
    r = np.random.default_rng(5)
    c = r.standard_normal((64, 48))
    db = (c[r.integers(0, 64, 20000)] + 0.3 * r.standard_normal(
        (20000, 48))).astype(np.float32)
    q = (c[r.integers(0, 64, 256)] + 0.3 * r.standard_normal(
        (256, 48))).astype(np.float32)
    b = scann_torch.builder(db, 10, measure)
    if leaves is not None:
        b = b.tree(num_leaves=leaves, num_leaves_to_search=min(4, leaves),
                   training_sample_size=10000)
    b = b.score_brute_force(quantize)
    if reorder is not None:
        b = b.reorder(30, quantize=reorder)
    config = b.create_config()
    if reorder is not None:
        config = dataclasses.replace(config, reordering=dataclasses.replace(
            config.reordering, residual=residual))
    s = scann_torch.create_searcher(db, config, "cuda")
    before = pruned_sq.launches
    gi, gd = s.search_batched(q)
    assert (pruned_sq.launches > before) == (
        leaves is not None and leaves > 1 and quantize == "int8")
    s.serialize(str(tmp_path))
    ci, cd = scann_torch.load_searcher(str(tmp_path),
                                       device="cpu").search_batched(q)
    assert (gi[:, :, None] == ci[:, None, :]).any(-1).mean() >= 0.999
    same = (gi == ci) & (gi >= 0)
    scale = np.abs(cd)
    if measure == "squared_l2":
        scale = scale + (q ** 2).sum(1)[:, None] + (
            db[np.maximum(ci, 0)] ** 2).sum(-1)
    assert np.all(np.abs(gd - cd)[same] <= 1e-4 * scale[same] + 1e-6)


@pytest.mark.parametrize("lookup", ["int8", "reconstruct"])
def test_cuda_soar_layout_kernels_and_search(cuda, lookup, tmp_path,
                                             monkeypatch):
    """A SOAR index (two slots a row) built on the card: every K3, K2 and K5
    launch of its searches is held against the plain version on the same
    inputs (K3 bit-equal, K2 and K5 at their bars above); the searches
    return no id twice and agree with the CPU plain path."""
    import dataclasses
    from scann_torch.ops import topk
    r = np.random.default_rng(2)
    db = r.standard_normal((20000, 48)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = r.standard_normal((256, 48)).astype(np.float32)
    config = (scann_torch.builder(db, 10, "dot_product")
              .tree(num_leaves=32, num_leaves_to_search=4,
                    training_sample_size=10000, soar_lambda=1.5)
              .score_ah(2, anisotropic_quantization_threshold=0.2,
                        training_sample_size=10000)
              .reorder(20).create_config())
    config = dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type=lookup))
    s = scann_torch.create_searcher(db, config, "cuda")
    assert s._num_slots == 2 * len(db)
    held = []

    def k3(plan, q_rows, *rest, _f=pruned_lut.score_work_lut, **kw):
        got = _f(plan, q_rows, *rest, **kw)
        want = pruned_lut.score_work_torch_lut(
            plan, q_rows[plan.qg_query.long()], *rest, **kw)
        a, b = _active_pair(plan, got, want, kw["kpg"])
        assert a.numel() and torch.equal(a, b)
        held.append("k3")
        return got

    def k2(plan, *args, _f=ps.score_work, **kw):
        got = _f(plan, *args, **kw)
        _hold_k2(plan, got, ps.score_work_torch(plan, *args, **kw),
                 kw["kpg"])
        held.append("k2")
        return got

    def k5(q_bf, rows, bias, _f=fused_scan.fused_scan_groupmax, **kw):
        gv, gi = _f(q_bf, rows, bias, **kw)
        wv, wi = fused_scan.fused_scan_groupmax_torch(q_bf, rows, bias, **kw)
        tol = 1e-5 * wv.abs() + 1e-5
        assert torch.all((gv - wv).abs() <= tol)
        assert (gi == wi).double().mean() >= 0.999
        held.append("k5")
        return gv, gi

    monkeypatch.setattr(pruned_lut, "score_work_lut", k3)
    monkeypatch.setattr(ps, "score_work", k2)
    monkeypatch.setattr(fused_scan, "fused_scan_groupmax", k5)
    s.serialize(str(tmp_path))
    cpu = scann_torch.load_searcher(str(tmp_path), device="cpu")
    searches = [dict(leaves_to_search=4)]
    if lookup == "reconstruct":
        searches.append(dict(leaves_to_search=10 ** 6))   # the full scan
    for kw in searches:
        gi, gd = s.search_batched(q, **kw)
        for row in gi:
            row = row[row >= 0]
            assert len(set(row)) == len(row)
        ci, cd = cpu.search_batched(q, **kw)
        assert (gi[:, :, None] == ci[:, None, :]).any(-1).mean() >= 0.999
        same = gi == ci
        np.testing.assert_allclose(gd[same], cd[same], rtol=1e-4, atol=1e-4)
    want = {"int8": {"k3"}, "reconstruct": {"k2", "k5"}}[lookup]
    assert set(held) == want
    # dedup on the card equals the CPU's.
    vals = torch.as_tensor(r.integers(0, 5, (64, 40)).astype(np.float32))
    ids = torch.as_tensor(r.integers(-1, 30, (64, 40)).astype(np.int32))
    for a, b in zip(topk.dedup_candidates(vals.to(cuda), ids.to(cuda)),
                    topk.dedup_candidates(vals, ids)):
        assert torch.equal(a.cpu(), b)


def test_crowding_and_sort_on_cuda_equal_cpu(cuda):
    from scann_torch.ops import topk
    r = np.random.default_rng(5)
    vals = torch.as_tensor(r.integers(0, 8, (96, 50)).astype(np.float32))
    ids = torch.as_tensor(r.integers(-1, 400, (96, 50)).astype(np.int32))
    vals = torch.where(ids < 0, float("-inf"), vals)
    attrs = torch.as_tensor(r.integers(0, 6, (96, 50, 2)).astype(np.int32))
    for fn, args in ((topk.sort_results, (vals, ids)),
                     (topk.crowding_rank, (vals, ids, attrs[..., 0])),
                     (topk.crowding_filter, (vals, ids, attrs[..., 1], 2)),
                     (topk.crowding_filter_multi, (vals, ids, attrs,
                                                   (2, 3)))):
        on_card = fn(*[a.to(cuda) if torch.is_tensor(a) else a
                       for a in args])
        on_cpu = fn(*args)
        if torch.is_tensor(on_cpu):
            on_card, on_cpu = (on_card,), (on_cpu,)
        for a, b in zip(on_card, on_cpu):
            assert torch.equal(a.cpu(), b)
