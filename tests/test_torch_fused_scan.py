"""K5 (fused score + group max) of the port against scann_tpu.

The same numpy-seeded bf16 rows, bias and queries go through
``scann_torch.ops.fused_scan.fused_scan_groupmax_torch`` (the plain version
of the CUDA kernel csrc/fused_scan.cu) and through the JAX package's Pallas
kernel in interpret mode, at the shapes of tests/test_fused_scan.py.
bf16 x bf16 products are exact in f32 and only the order of the f32 sum
differs, so the group maxima agree within 1e-5 relative plus 1e-5, the
slot ids on >= 99.9% of groups, and where they differ the two slots' scores
lie within that tolerance of each other (a tie up to summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_torch.ops import fused_scan as tfs
from scann_tpu.ops import fused_scan as jfs

RTOL, ATOL, MIN_ID = 1e-5, 1e-5, 0.999


def _both(qs, rows, bias, l2):
    q_t = torch.from_numpy(qs).to(torch.bfloat16)
    r_t = torch.from_numpy(rows).to(torch.bfloat16)
    gv, gi = tfs.fused_scan_groupmax_torch(q_t, r_t, torch.from_numpy(bias),
                                           measure_l2=l2)
    wv, wi = jfs.fused_scan_groupmax(
        jnp.asarray(qs, jnp.bfloat16), jnp.asarray(rows, jnp.bfloat16),
        jnp.asarray(bias), measure_l2=l2, interpret=True)
    sim = (2.0 if l2 else 1.0) * (q_t.float() @ r_t.float().T).numpy() \
        + bias[None, :]
    return gv.numpy(), gi.numpy(), np.array(wv), np.array(wi), sim


def _hold(gv, gi, wv, wi, sim):
    assert gv.shape == wv.shape and gi.shape == wi.shape
    assert gi.dtype == np.int32 and gv.dtype == np.float32
    tol = RTOL * np.abs(wv) + ATOL
    assert np.all(np.abs(gv - wv) <= tol), np.abs(gv - wv).max()
    same = gi == wi
    assert same.mean() >= MIN_ID, same.mean()
    alt = np.take_along_axis(sim, gi, axis=1)
    assert np.all(np.abs(alt - wv)[~same] <= tol[~same])


def test_k5_plain_version_matches_jax_dot():
    rng = np.random.default_rng(0)
    s, d, q = 2 * jfs.BS, 128, jfs.QT
    rows = rng.standard_normal((s, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    bias = jfs.build_bias(np.ones(s, bool))
    gv, gi, wv, wi, sim = _both(qs, rows, bias, False)
    assert gv.shape == (q, s // tfs.SUB)
    _hold(gv, gi, wv, wi, sim)
    # The oracle of the JAX package's own test: per-group max and argmax.
    grouped = sim.reshape(q, -1, tfs.SUB)
    np.testing.assert_allclose(gv, grouped.max(-1), rtol=1e-6)
    np.testing.assert_array_equal(
        gi, grouped.argmax(-1) + np.arange(grouped.shape[1])[None] * tfs.SUB)


def test_k5_plain_version_matches_jax_l2_with_padding():
    rng = np.random.default_rng(1)
    s_real, d_real, q = 3000, 100, jfs.QT
    rows = rng.standard_normal((s_real, d_real)).astype(np.float32)
    qs = rng.standard_normal((q, d_real)).astype(np.float32)
    rows_p, s_pad = tfs.pad_for_kernel(rows)
    rows_j, s_pad_j = jfs.pad_for_kernel(rows)
    assert s_pad == s_pad_j == 4096 and rows_p.shape == (4096, 128)
    np.testing.assert_array_equal(rows_p, rows_j)
    qs_p = np.zeros((q, 128), np.float32)
    qs_p[:, :d_real] = qs
    valid = np.zeros(s_pad, bool)
    valid[:s_real] = True
    sq = np.zeros(s_pad, np.float32)
    sq[:s_real] = (rows * rows).sum(1)
    bias = tfs.build_bias(valid, sq)
    np.testing.assert_array_equal(bias, jfs.build_bias(valid, sq))
    assert tfs._PAD_PENALTY == jfs._PAD_PENALTY and tfs.SUB == jfs.SUB \
        and tfs.BS == jfs.BS
    gv, gi, wv, wi, sim = _both(qs_p, rows_p, bias, True)
    _hold(gv, gi, wv, wi, sim)
    real = gv > -1e20
    assert np.all(gi[real] < s_real)      # no padding slot is selected
    assert (~real).any()                  # all-padding groups stay dead


def test_k5_ties_take_the_first_slot_of_the_group():
    """Equal rows score equally: the group's first such slot is reported,
    as jnp.argmax does."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal((8, 128)).astype(np.float32)
    rows = np.tile(base, (tfs.BS // 8, 1))      # every row 256 times a group
    qs = rng.standard_normal((16, 128)).astype(np.float32)
    bias = np.zeros(tfs.BS, np.float32)
    gv, gi = tfs.fused_scan_groupmax_torch(
        torch.from_numpy(qs).to(torch.bfloat16),
        torch.from_numpy(rows).to(torch.bfloat16), torch.from_numpy(bias))
    in_group = gi.numpy() % tfs.SUB
    assert in_group.max() < 8                   # the first copy, never a later
    np.testing.assert_array_equal(gi.numpy() // tfs.SUB,
                                  np.arange(tfs.BS // tfs.SUB)[None].repeat(
                                      16, 0))


@pytest.mark.parametrize("nq", [1, 5, 300])
def test_k5_wrapper_takes_any_query_count_and_counts_no_cpu_call(nq):
    """The wrapper has no 256-query rule (the port has no batch buckets);
    a query's result does not depend on the batch it rides in."""
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.standard_normal((tfs.BS, 128)).astype(
        np.float32)).to(torch.bfloat16)
    qs = torch.from_numpy(rng.standard_normal((300, 128)).astype(
        np.float32)).to(torch.bfloat16)
    bias = torch.zeros(tfs.BS)
    before = tfs.launches
    v, i = tfs.fused_scan_groupmax(qs[:nq], rows, bias)
    assert tfs.launches == before               # only kernel launches count
    fv, fi = tfs.fused_scan_groupmax_torch(qs, rows, bias)
    assert v.shape == (nq, tfs.BS // tfs.SUB)
    assert torch.equal(i, fi[:nq])
    torch.testing.assert_close(v, fv[:nq], rtol=1e-6, atol=1e-6)


def test_k5_wrapper_rejects_unaligned_shapes():
    q = torch.zeros((4, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported shapes"):
        tfs.fused_scan_groupmax(q, torch.zeros((1000, 128),
                                               dtype=torch.bfloat16),
                                torch.zeros(1000))
    with pytest.raises(ValueError, match="unsupported shapes"):
        tfs.fused_scan_groupmax(q[:, :100], torch.zeros(
            (2048, 100), dtype=torch.bfloat16), torch.zeros(2048))
    # The kernel's block streams its query tile beside the rows: 4 stages
    # of 256 row + 128 query chunks of 64 bf16 dimensions, at every width.
    assert tfs.smem_bytes() == 4 * 384 * 128 + 1024 <= 232_448
    assert tfs.QT == 128
