"""Tests of the port that need a CUDA card (marker ``cuda``): the K1, K3
and K4 CUDA kernels against their plain torch versions, the CUDA search
paths (tree-SQ and tree-AH) against the CPU plain path on the same index,
and the wrappers' refusal of bad inputs.
They skip without a card.  On a machine with one (no JAX needed; the
repository's conftest imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerance of K1 and K4 against their plain versions: unpacked values
within rtol 2^-14 (identity perturbation plus summation order), packed
identities equal on >= 99.9% of active survivors.  K3 at two dimensions
per block: packed survivors bit-equal (exact products, one rounded sum per
LUT entry, exact integer sums)."""

import numpy as np
import pytest
import torch

import scann_torch
from scann_torch.ops import pruned_lut
from scann_torch.ops import pruned_scan as ps
from scann_torch.ops import pruned_sq

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


@pytest.mark.parametrize("measure_l2", [False, True])
@pytest.mark.parametrize("kpg", [4, 8])
def test_k1_kernel_matches_plain_version(cuda, measure_l2, kpg):
    plan, qg, rows, scale, bias = _case(cuda, 1 + kpg + measure_l2)
    before = pruned_sq.launches
    got = pruned_sq.score_work_sq(plan, qg, rows, scale, bias,
                                  measure_l2=measure_l2, kpg=kpg)
    assert pruned_sq.launches == before + 1
    want = pruned_sq.score_work_torch_sq(plan, qg, rows, scale, bias,
                                         measure_l2=measure_l2, kpg=kpg)
    torch.cuda.synchronize()
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, 128, mnt, kpg * 8)
    a = got.reshape(act.shape)[act]
    b = want.reshape(act.shape)[act]
    va, vb = ps._unpack(a)[0].double(), ps._unpack(b)[0].double()
    assert torch.all((va - vb).abs() <= 2.0 ** -14 * vb.abs() + 1e-6)
    assert ((a & 511) == (b & 511)).double().mean() >= 0.999


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


def _ah_case(dev, seed, cpb, dpb, l2, b=50, nl=40, nq=300, l=6):
    """A tree-AH scoring problem at the bench's block count (50 blocks,
    b_pad 56) in the port's layout (d_pad = b_pad * dpb)."""
    r = np.random.default_rng(seed)
    b_pad = -(-b // 8) * 8
    d_pad = b_pad * dpb
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
    qg = t(q).to(torch.bfloat16)[plan.qg_query.long()]
    return plan, qg, codes, pad_slot, t(cb), t(mean), t(bias), num_tiles


def _active_pair(plan, got, want, kpg):
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, 128, mnt, kpg * 16)
    return got.reshape(act.shape)[act], want.reshape(act.shape)[act]


@pytest.mark.parametrize("measure_l2", [False, True])
@pytest.mark.parametrize("kpg", [8, 16])
def test_k3_kernel_bit_equal_to_plain_version(cuda, measure_l2, kpg):
    plan, qg, codes, pad, cb, mean, bias, nt = _ah_case(
        cuda, 20 + kpg + measure_l2, 16, 2, measure_l2)
    codes3p = torch.as_tensor(pruned_lut.pack_codes_nibble(
        np.where(pad[:, None], 0, codes).astype(np.uint8), nt), device=cuda)
    cb_k, csq = pruned_lut.lut_tables(cb, mean, codes3p.shape[-1] * 2,
                                      measure_l2=measure_l2)
    args = (plan, qg, codes3p, cb_k, csq, bias)
    before = pruned_lut.launches_lut
    got = pruned_lut.score_work_lut(*args, measure_l2=measure_l2, kpg=kpg)
    assert pruned_lut.launches_lut == before + 1
    want = pruned_lut.score_work_torch_lut(*args, measure_l2=measure_l2,
                                           kpg=kpg)
    torch.cuda.synchronize()
    a, b = _active_pair(plan, got, want, kpg)
    assert a.numel() and torch.equal(a, b)


@pytest.mark.parametrize("measure_l2", [False, True])
@pytest.mark.parametrize("cpb,dpb,b,kpg", [(16, 2, 50, 8), (16, 2, 50, 16),
                                            (256, 4, 25, 8)])
def test_k4_kernel_matches_plain_version(cuda, measure_l2, cpb, dpb, b, kpg):
    plan, qg, codes, pad, cb, mean, bias, nt = _ah_case(
        cuda, 40 + cpb + kpg + measure_l2, cpb, dpb, measure_l2, b=b)
    codes3 = torch.as_tensor(pruned_lut.pack_codes_tiles(
        np.where(pad[:, None], 255, codes).astype(np.uint8), nt),
        device=cuda)
    args = (plan, qg, codes3,
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


def test_k3_k4_wrappers_reject_bad_inputs(cuda):
    plan, qg, codes, pad, cb, mean, bias, nt = _ah_case(cuda, 7, 16, 2,
                                                        False)
    codes3 = torch.as_tensor(pruned_lut.pack_codes_tiles(codes, nt),
                             device=cuda)
    with pytest.raises(ValueError, match="qg_rows"):
        pruned_lut.score_work_codes(
            plan, qg.float(), codes3,
            pruned_lut.codes_table(cb, codes3.shape[-1]), mean, bias,
            measure_l2=False)
    wide = torch.zeros((1, 512, 104 // 2), dtype=torch.uint8, device=cuda)
    cb_k, csq = pruned_lut.lut_tables(cb, mean, codes3.shape[-1],
                                      measure_l2=False)
    with pytest.raises(ValueError, match="shared memory"):
        pruned_lut.score_work_lut(plan, qg, wide, cb_k, csq, bias,
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
