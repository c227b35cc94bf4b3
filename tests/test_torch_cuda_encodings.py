"""Card tests of the data and encodings paths (marker ``cuda``; they skip
without a card): typed int8 / uint8 brute force and tree-SQ built on the
card return what the same index returns on the CPU plain path; K3 on a
PCA index's projected width is bit-equal to its plain version; K2 and K5
on stacked and variable-chunk layouts stay within their bars (values
within 2^-14 relative plus 1e-5 and identities >= 99.99% for K2; values
within 1e-5 relative plus 1e-5 and slots >= 99.9% for K5, as in
tests/test_torch_cuda.py); and TF32 stays off.  On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_encodings.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import scann_torch
from scann_torch.ops import fused_scan
from scann_torch.ops import pruned_lut
from scann_torch.ops import pruned_scan as ps
from scann_torch.ops import pruned_sq
import torch_threads  # noqa: F401  (torch threads per xdist worker)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_tf32_is_off(cuda):
    """The port never turns TF32 on: float32 products stay float32."""
    assert not torch.backends.cuda.matmul.allow_tf32
    scann_torch.builder(np.ones((64, 8), np.float32), 3, "dot_product"
                        ).score_brute_force().build()
    assert not torch.backends.cuda.matmul.allow_tf32


def _active(plan, got, want, kpg):
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, 128, mnt, kpg * 16)
    return got.reshape(act.shape)[act], want.reshape(act.shape)[act]


def _hold_k2(plan, got, want, kpg):
    a, b = _active(plan, got, want, kpg)
    va, vb = ps._unpack(a)[0].double(), ps._unpack(b)[0].double()
    assert a.numel()
    assert torch.all((va - vb).abs() <= 2.0 ** -14 * vb.abs() + 1e-5)
    assert ((a & 511) == (b & 511)).double().mean() >= 0.9999


def _hold_k5(got, want):
    (gv, gi), (wv, wi) = got, want
    assert torch.all((gv - wv).abs() <= 1e-5 * wv.abs() + 1e-5)
    assert (gi == wi).double().mean() >= 0.999


def _same_as_cpu(s, q, measure, db, tmp_path, **kw):
    gi, gd = s.search_batched(q, **kw)
    s.serialize(str(tmp_path))
    ci, cd = scann_torch.load_searcher(str(tmp_path),
                                       device="cpu").search_batched(q, **kw)
    assert (gi[:, :, None] == ci[:, None, :]).any(-1).mean() >= 0.999
    same = (gi == ci) & (gi >= 0)
    scale = np.abs(cd)
    if measure == "squared_l2":
        x = db.astype(np.float64)
        scale = scale + (q ** 2).sum(1)[:, None] + (
            x[np.maximum(ci, 0)] ** 2).sum(-1)
    assert np.all(np.abs(gd - cd)[same] <= 1e-4 * scale[same] + 1e-6)


@pytest.mark.parametrize("dtype", ["uint8", "int8"])
@pytest.mark.parametrize("engine", ["brute_force", "tree_sq"])
def test_typed_index_on_cuda_equals_cpu(cuda, dtype, engine, tmp_path):
    r = np.random.default_rng(3)
    c = r.uniform(-60, 60, (64, 48))
    x = c[r.integers(0, 64, 20000)] + 10 * r.standard_normal((20000, 48))
    q = (c[r.integers(0, 64, 256)] + 10 * r.standard_normal((256, 48)))
    off, lo, hi = (128, 0, 255) if dtype == "uint8" else (0, -127, 127)
    db = np.clip(np.rint(x + off), lo, hi).astype(dtype)
    q = (q + off).astype(np.float32)
    b = scann_torch.builder(db, 10, "squared_l2")
    if engine == "tree_sq":
        b = b.tree(num_leaves=32, num_leaves_to_search=4,
                   training_sample_size=10000).score_brute_force("int8")
    else:
        b = b.score_brute_force()
    s = b.build()
    if engine == "brute_force":
        assert s._db.dtype == getattr(torch, dtype)   # 1 B a dimension
    before = pruned_sq.launches
    s.search_batched(q)
    assert (pruned_sq.launches > before) == (engine == "tree_sq")
    _same_as_cpu(s, q, "squared_l2", db, tmp_path)


def test_k3_at_a_projected_width_is_bit_equal(cuda, tmp_path, monkeypatch):
    """pca(40) + tree-AH int8 lookup: b_pad 24 (20 blocks of 2), every K3
    launch of a search held bit-equal to its plain version."""
    r = np.random.default_rng(4)
    db = (r.standard_normal((20000, 96)) * np.linspace(3, 0.1, 96)
          ).astype(np.float32)
    q = (r.standard_normal((256, 96)) * np.linspace(3, 0.1, 96)
         ).astype(np.float32)
    s = (scann_torch.builder(db, 10, "squared_l2")
         .tree(num_leaves=32, num_leaves_to_search=4,
               training_sample_size=10000)
         .pca(40, pca_significance_threshold=None)
         .score_ah(2, anisotropic_quantization_threshold=0.2)
         .reorder(20).build())
    held = []

    def k3(plan, q_rows, *rest, _f=pruned_lut.score_work_lut, **kw):
        got = _f(plan, q_rows, *rest, **kw)
        want = pruned_lut.score_work_torch_lut(
            plan, q_rows[plan.qg_query.long()], *rest, **kw)
        a, b = _active(plan, got, want, kw["kpg"])
        assert a.numel() and torch.equal(a, b)
        held.append(q_rows.shape[-1])
        return got

    monkeypatch.setattr(pruned_lut, "score_work_lut", k3)
    _same_as_cpu(s, q, "squared_l2", db, tmp_path)
    assert held and held[0] == 48       # d_pad: b_pad 24 x 2 dimensions
    assert s._p_codes.shape[-1] * 2 == 24


@pytest.mark.parametrize("kind", ["stacked", "variable"])
@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_k2_and_k5_on_stacked_and_variable_layouts(cuda, kind, measure,
                                                   tmp_path, monkeypatch):
    r = np.random.default_rng(6)
    c = r.standard_normal((64, 48))
    db = (c[r.integers(0, 64, 20000)] + 0.3 * r.standard_normal(
        (20000, 48))).astype(np.float32)
    q = (c[r.integers(0, 64, 256)] + 0.3 * r.standard_normal(
        (256, 48))).astype(np.float32)
    ah = (dict(quantization_scheme="stacked") if kind == "stacked" else
          dict(variable_dims_per_block=[4] * 6 + [2] * 12))
    config = (scann_torch.builder(db, 10, measure)
              .tree(num_leaves=32, num_leaves_to_search=4,
                    training_sample_size=10000)
              .score_ah(2, **ah).reorder(20).create_config())
    config = dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type="reconstruct"))
    s = scann_torch.create_searcher(db, config, "cuda")
    assert s._pruned_available
    held = []

    def k2(plan, *args, _f=ps.score_work, **kw):
        got = _f(plan, *args, **kw)
        _hold_k2(plan, got, ps.score_work_torch(plan, *args, **kw),
                 kw["kpg"])
        held.append("k2")
        return got

    def k5(q_bf, rows, bias, _f=fused_scan.fused_scan_groupmax, **kw):
        got = _f(q_bf, rows, bias, **kw)
        _hold_k5(got, fused_scan.fused_scan_groupmax_torch(q_bf, rows, bias,
                                                           **kw))
        held.append("k5")
        return got

    monkeypatch.setattr(ps, "score_work", k2)
    monkeypatch.setattr(fused_scan, "fused_scan_groupmax", k5)
    _same_as_cpu(s, q, measure, db, tmp_path, leaves_to_search=4)
    _same_as_cpu(s, q, measure, db, tmp_path, leaves_to_search=10 ** 6)
    assert held.count("k2") >= 1 and held.count("k5") >= 1
