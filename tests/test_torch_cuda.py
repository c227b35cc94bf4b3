"""Tests of the port that need a CUDA card (marker ``cuda``): the K1 CUDA
kernel against its plain torch version, the CUDA search path against the
CPU plain path on the same index, and the wrapper's refusal of bad inputs.
They skip without a card.  On a machine with one (no JAX needed; the
repository's conftest imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerance of K1 against the plain version: unpacked values within rtol
2^-14 (identity perturbation plus summation order), packed identities
equal on >= 99.9% of active survivors."""

import numpy as np
import pytest
import torch

import scann_torch
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
