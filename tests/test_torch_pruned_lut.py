"""The tree-AH scorers of scann_torch.ops.pruned_lut against scann_tpu on
the same numpy inputs: the code packers and the expanded codebook, and the
plain torch versions of K3 (int8-LUT scorer) and K4 (decode scorer) against
the JAX package's XLA twins and its Pallas kernels run in interpret mode.

Tolerances: packers and codebook equal.  K3 at two dimensions per block:
packed survivors bit-equal on active segments (a LUT entry is one rounded
sum of two exact products, and the integer sums are exact).  One case is
set aside: a score of exactly 0 becomes a denormal once its identity is
packed, and XLA's CPU backend flushes denormals to zero, which drops the
identity and masks every such slot of the group at once; torch and the
CUDA kernel keep denormals.  Candidate groups that hold such a survivor
(2 to 8 percent of the random cases here, whose integer sums cluster
around zero) are left out of the comparison with the JAX package.  That
the fault is the reference's is shown, not assumed: a numpy recomputation
that selects by integer comparison (_k3_numpy) equals the port on every
group, those included, and wherever the JAX package differs from it the
JAX output holds an all-zero word, the flushed survivor.  K4: unpacked
values within rtol 2^-14 (the <= 2^-15 identity perturbation plus the
order of the f32 sum over the dimensions; atol 1e-5 for squared-L2 scores
2 dot - ||x||^2 that cancel to near zero from terms of order 10) and
packed identities equal on >= 99.9% of active survivors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_torch.ops import pruned_lut as tpl
from scann_torch.ops import pruned_scan as tps
from scann_tpu.ops import pruned_lut as jpl
from scann_tpu.ops import pruned_scan as jps
import torch_threads  # noqa: F401  (torch threads per xdist worker)

TILE = 512
K4_RTOL, K4_MIN_ID_AGREE = 2.0 ** -14, 0.999


def _codes(r, n, b, cpb):
    return r.integers(0, cpb, (n, b)).astype(np.uint8)


@pytest.mark.parametrize("b", [5, 16])
def test_packers_equal(b):
    r = np.random.default_rng(b)
    c16, c256 = _codes(r, 3 * TILE, b, 16), _codes(r, 3 * TILE, b, 256)
    np.testing.assert_array_equal(tpl.pack_codes_nibble(c16, 3),
                                  jpl.pack_codes_nibble(c16, 3))
    np.testing.assert_array_equal(tpl.pack_codes_tiles(c256, 3),
                                  jpl.pack_codes_tiles(c256, 3))
    assert tpl.pack_codes_nibble(c16, 3).dtype == np.uint8


@pytest.mark.parametrize("cpb,dpb", [(16, 2), (256, 4), (16, 3)])
def test_expand_and_centered_codebook_equal(cpb, dpb):
    r = np.random.default_rng(cpb + dpb)
    b, b_pad = 5, 8
    d_pad = b_pad * dpb
    cb = r.standard_normal((b, cpb, dpb)).astype(np.float32)
    want = jpl.expand_codebook(cb, d_pad, b_pad)
    got = tpl.expand_codebook(cb, d_pad, b_pad)
    np.testing.assert_array_equal(got, want)
    if cpb == 16:
        mean = np.zeros(d_pad, np.float32)
        mean[:b * dpb] = r.standard_normal(b * dpb)
        wc, ws = jpl._centered_cb(jnp.asarray(want), jnp.asarray(mean), dpb)
        wc = np.asarray(wc.astype(jnp.bfloat16).astype(jnp.float32))
        for l2 in (False, True):
            cb_k, csq = tpl.lut_tables(torch.from_numpy(cb),
                                       torch.from_numpy(mean), b_pad,
                                       measure_l2=l2)
            # The compact table is the expanded one without its zeros.
            np.testing.assert_array_equal(
                tpl.expand_codebook(cb_k.numpy().reshape(b_pad, 16, dpb),
                                    d_pad, b_pad), wc)
            np.testing.assert_allclose(
                csq.numpy(), np.asarray(ws)[:, 0] if l2 else 0.0, rtol=1e-6)
        assert not cb_k.numpy()[b * 16:].any()
    table = tpl.codes_table(torch.from_numpy(cb), b_pad).numpy()
    np.testing.assert_array_equal(
        tpl.expand_codebook(table.reshape(b_pad, cpb, dpb), d_pad, b_pad),
        np.asarray(jnp.asarray(want).astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def _case(seed, small, cpb, dpb, l2, b=13):
    """A small tree-AH scoring problem: layout, plan, codes, planes."""
    r = np.random.default_rng(seed)
    nl = 6
    b_pad = -(-b // 8) * 8
    d_pad = b_pad * dpb
    ntiles = r.integers(1, 3, nl).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    num_tiles = int(ntiles.sum())
    nb, l = (5, 3) if small else (70, 3)
    sel = np.stack([r.choice(nl, l, replace=False)
                    for _ in range(nb)]).astype(np.int32)
    valid = r.random((nb, l)) < 0.85
    codes = _codes(r, num_tiles * TILE, b, cpb)
    pad_slot = r.random(num_tiles * TILE) < 0.1
    bias = np.where(pad_slot, -1e30, 0.0).astype(np.float32)
    bias = bias + np.where(r.random(bias.shape) < 0.2, -1e30,
                           0.0).astype(np.float32)          # a restrict
    cb = (0.3 * r.standard_normal((b, cpb, dpb))).astype(np.float32)
    mean = np.zeros(d_pad, np.float32)
    if l2:
        mean[:b * dpb] = 0.1 * r.standard_normal(b * dpb)
    q = np.zeros((nb, d_pad), np.float32)
    q[:, :b * dpb] = r.standard_normal((nb, b * dpb))
    cb_mat = jpl.expand_codebook(cb, d_pad, b_pad)
    mnt = int(ntiles.max())
    targs = (torch.from_numpy(sel), torch.from_numpy(valid),
             torch.from_numpy(tile_start), torch.from_numpy(ntiles))
    jargs = tuple(jnp.asarray(a.numpy()) for a in targs)
    if small:
        tplan = tps.invert_small(*targs, mnt)
        jplan = jps.invert_small(*jargs, mnt)
    else:
        g_pad, w_pad = tps.plan_capacities(nb, l, nl, num_tiles, mnt)
        tplan = tps.invert(*targs, mnt, g_pad, w_pad)
        jplan = jps.invert(*jargs, mnt, g_pad, w_pad)
    q_bf = torch.from_numpy(q).to(torch.bfloat16)
    qg_t = q_bf[tplan.qg_query.long()]
    qg_j = jnp.asarray(q).astype(jnp.bfloat16)[jplan.qg_query]
    np.testing.assert_array_equal(qg_t.float().numpy(),
                                  np.asarray(qg_j.astype(jnp.float32)))
    return dict(tplan=tplan, jplan=jplan, q_t=q_bf, qg_t=qg_t, qg_j=qg_j,
                codes=codes, pad_slot=pad_slot,
                bias=bias.reshape(num_tiles, TILE, 1), cb_mat=cb_mat,
                cb=torch.from_numpy(cb), b_pad=b_pad, mean=mean,
                num_tiles=num_tiles)


def _active(packed, plan, kpg):
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    act = np.asarray(plan.work_active).reshape(g_pad, mnt).astype(bool)
    p = np.asarray(packed).reshape(g_pad, 128, mnt, kpg * 16)
    return p.transpose(0, 2, 1, 3)[act]


def _by_group(active, kpg):
    """(n, QG, kpg*16) survivors -> (n, QG, 16 groups, kpg passes)."""
    n, qg, _ = active.shape
    return active.reshape(n, qg, kpg, 16).transpose(0, 1, 3, 2)


def _bf16(x):
    """float32 -> nearest-even bfloat16 value, held in float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _k3_numpy(c, codes, l2, kpg):
    """K3 at two dimensions per block recomputed in numpy float32 from the
    raw codebook and codes, every rounding step written out, and the top
    kpg of each 32-slot group chosen by integer comparison of the packed
    bits, so no floating-point mode (such as a flush of denormals) can
    touch an identity.  Returns the active survivors as
    (n, QG, 16 groups, kpg)."""
    f32 = np.float32
    plan, b_pad = c["tplan"], c["b_pad"]
    cb = np.zeros((b_pad, 16, 2), f32)
    cb[:c["cb"].shape[0]] = c["cb"].numpy()
    cb_c = cb - c["mean"].reshape(b_pad, 1, 2)
    csq = (cb_c[..., 0] * cb_c[..., 0] + cb_c[..., 1] * cb_c[..., 1]
           if l2 else np.zeros((b_pad, 16), f32))
    cb_bf = _bf16(cb_c)
    full = np.zeros((codes.shape[0], b_pad), np.int64)
    full[:, :codes.shape[1]] = codes
    full = full.reshape(c["num_tiles"], TILE, b_pad)
    bias = c["bias"].reshape(c["num_tiles"], TILE)
    q = c["qg_t"].float().numpy()
    work_tile, work_qg, work_active = (
        np.asarray(a) for a in (plan.work_tile, plan.work_qg,
                                plan.work_active))
    mnt = work_tile.shape[0] // q.shape[0]
    sub = np.arange(TILE, dtype=np.int32) % 32
    out = []
    for w in np.nonzero(work_active == 1)[0]:
        qq = q[work_qg[w]].reshape(128, b_pad, 1, 2)
        lutf = cb_bf[None, ..., 0] * qq[..., 0] + cb_bf[None, ..., 1] * qq[
            ..., 1]                                       # (QG, b_pad, 16)
        lutf = f32(2.0 if l2 else 1.0) * lutf - csq[None]
        m = np.maximum(np.abs(lutf).max(axis=(1, 2)), f32(1e-20))
        lut = np.clip(np.rint(lutf * (f32(127.0) / m)[:, None, None]),
                      -127, 127).astype(np.int32)
        ct = full[work_tile[w]]                           # (TILE, b_pad)
        acc = lut[:, np.arange(b_pad)[None, :], ct].sum(-1)   # (QG, TILE)
        s = acc.astype(f32) * (m * f32(1.0 / 127.0))[:, None] \
            + bias[work_tile[w]][None, :]
        assert lutf.dtype == f32 and s.dtype == f32
        bits = (s.view(np.int32) & ~np.int32(511)) | (
            np.int32((w % mnt) << 5) | sub)[None, :]
        bits = bits.reshape(128, 16, 32)
        key = (bits ^ ((bits >> 31) & np.int32(0x7FFFFFFF))).astype(np.int64)
        top = np.argsort(-key, axis=-1)[..., :kpg]
        out.append(np.take_along_axis(bits, top, axis=-1))
    return np.stack(out)


# Least share of candidate groups without a zero-score survivor over the
# cases below (observed 0.9183 to 0.9912); a growing exclusion fails.
K3_MIN_KEPT = 0.91


@pytest.mark.parametrize("l2", [False, True], ids=["dot", "l2"])
@pytest.mark.parametrize("kpg", [8, 16])
@pytest.mark.parametrize("small", [False, True], ids=["invert", "small"])
def test_k3_plain_version_bit_equal(l2, kpg, small):
    _hold_k3(_case(11 + kpg + 2 * l2 + small, small, 16, 2, l2), l2, kpg)


def test_k3_plain_version_bit_equal_past_the_old_width_limit():
    """100 code blocks (d = 200 at two dimensions per block, b_pad 104):
    over the 96 blocks K3's LUT admitted while a block held all 128
    queries; the card's kernel now streams the LUT and serves every
    b_pad (its shared memory is the same at every width)."""
    _hold_k3(_case(3, True, 16, 2, True, b=100), True, 8, pallas=False)


def _hold_k3(c, l2, kpg, pallas=True):
    """The port's K3 (the plain version on the CPU) bit-equal to the numpy
    witness on every group and to the JAX package's XLA twin (and, with
    ``pallas``, its Pallas kernel in interpret mode) off the zero-score
    groups."""
    codes = np.where(c["pad_slot"][:, None], 0, c["codes"]).astype(np.uint8)
    codes3p = jpl.pack_codes_nibble(codes, c["num_tiles"])
    got = tpl.score_work_lut(
        c["tplan"], c["q_t"], torch.from_numpy(codes3p),
        *tpl.lut_tables(c["cb"], torch.from_numpy(c["mean"]), c["b_pad"],
                        measure_l2=l2),
        torch.from_numpy(c["bias"]), measure_l2=l2, kpg=kpg)
    assert got.dtype == torch.int32
    jargs = (c["jplan"], jnp.swapaxes(c["qg_j"], 1, 2), jnp.asarray(codes3p),
             jnp.asarray(c["cb_mat"]), jnp.asarray(c["mean"]),
             jnp.asarray(c["bias"]))
    want_xla = jpl.score_work_xla_lut(*jargs, dims_per_block=2,
                                      measure_l2=l2, kpg=kpg)
    wants = [want_xla]
    if pallas:
        wants.append(jpl.score_work_pallas_lut(
            *jargs, dims_per_block=2, measure_l2=l2, interpret=True, kpg=kpg))
    assert got.shape == tuple(want_xla.shape)
    g = _by_group(_active(got.numpy(), c["tplan"], kpg), kpg)
    assert g.size
    # The witness: the port is bit-equal to the numpy recomputation on
    # every group, the zero-score ones included.
    ref = _k3_numpy(c, codes, l2, kpg)
    np.testing.assert_array_equal(g, ref)
    keep = ((ref & ~np.int32(511) & np.int32(0x7FFFFFFF)) != 0).all(-1)
    assert keep.mean() >= K3_MIN_KEPT
    for want in wants:
        w = _by_group(_active(want, c["jplan"], kpg), kpg)
        # The JAX package agrees wherever no survivor scores exactly zero,
        # and where it differs it shows the flush: a survivor whose bits
        # are all zero (score 0, identity lost).
        np.testing.assert_array_equal(w[keep], ref[keep])
        differs = (w != ref).any(-1)
        assert ((w[differs] & np.int32(0x7FFFFFFF)) == 0).any(-1).all()


def _assert_k4_close(got, want):
    gv = (got & ~np.int32(511)).view(np.float32).astype(np.float64)
    wv = (want & ~np.int32(511)).view(np.float32).astype(np.float64)
    live = wv > -1e20
    np.testing.assert_array_equal(gv > -1e20, live)
    np.testing.assert_allclose(gv[live], wv[live], rtol=K4_RTOL, atol=1e-5)
    agree = np.mean((got & 511) == (want & 511))
    assert agree >= K4_MIN_ID_AGREE, agree


@pytest.mark.parametrize("l2", [False, True], ids=["dot", "l2"])
@pytest.mark.parametrize("cpb,dpb,kpg,small", [(16, 2, 8, False),
                                                (16, 2, 16, True),
                                                (256, 4, 8, False),
                                                (256, 4, 16, False)])
def test_k4_plain_version_close(l2, cpb, dpb, kpg, small):
    c = _case(31 + cpb + kpg + l2, small, cpb, dpb, l2)
    codes3 = jpl.pack_codes_tiles(
        np.where(c["pad_slot"][:, None], 255, c["codes"]).astype(np.uint8),
        c["num_tiles"])
    got = tpl.score_work_codes(
        c["tplan"], c["qg_t"], torch.from_numpy(codes3),
        tpl.codes_table(c["cb"], c["b_pad"]), torch.from_numpy(c["mean"]),
        torch.from_numpy(c["bias"]), measure_l2=l2, kpg=kpg)
    jargs = (c["jplan"], c["qg_j"], jnp.asarray(codes3),
             jnp.asarray(c["cb_mat"]), jnp.asarray(c["mean"]),
             jnp.asarray(c["bias"]))
    want_xla = jpl.score_work_xla_codes(*jargs, measure_l2=l2, kpg=kpg)
    g = _active(got.numpy(), c["tplan"], kpg)
    assert g.size
    _assert_k4_close(g, _active(want_xla, c["jplan"], kpg))
    if cpb == 16 or kpg == 8:
        want_pallas = jpl.score_work_pallas_codes(
            *jargs, measure_l2=l2, interpret=True, kpg=kpg)
        _assert_k4_close(g, _active(want_pallas, c["jplan"], kpg))


def test_cuda_entry_points_refuse_other_devices():
    """On the CPU the entry points run the plain versions and count no
    launch; a tensor on neither CPU nor CUDA is refused."""
    c = _case(5, True, 16, 2, False)
    before = (tpl.launches_lut, tpl.launches_codes)
    codes3 = torch.from_numpy(jpl.pack_codes_tiles(c["codes"],
                                                   c["num_tiles"]))
    tpl.score_work_codes(c["tplan"], c["qg_t"], codes3,
                         tpl.codes_table(c["cb"], c["b_pad"]),
                         torch.from_numpy(c["mean"]),
                         torch.from_numpy(c["bias"]), measure_l2=False)
    assert (tpl.launches_lut, tpl.launches_codes) == before
    with pytest.raises(ValueError, match="unsupported device"):
        tpl.score_work_lut(c["tplan"], c["q_t"], codes3.to("meta"), None,
                           None, None, measure_l2=False)
    # K4's block (csrc/tile_mma.cuh with the codes stage) takes no d_pad:
    # the bias and squared-norm planes, a ring of 32-dimension chunks (32
    # code bytes a slot, 64 bf16 queries in 80-byte rows, 32 mean values)
    # and the decoded bf16 chunk, which the staged survivors reuse at
    # every kpg the wrapper takes.
    assert {tps.tile_smem_bytes("codes", kpg)
            for kpg in range(1, tps.SUBP + 1)} == \
        {256 * 8 + 4 * (256 * 32 + 64 * 80 + 32 * 4) + 256 * 80}
    assert tps.tile_smem_bytes("codes", 32) <= tps._SMEM_LIMIT
