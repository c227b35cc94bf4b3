"""scann_torch's asymmetric-hashing ops, host helpers and reorder helper
against scann_tpu on the same numpy inputs.

On a codebook trained by the JAX package: ``encode``,
``encode_noise_shaped`` and ``reconstruct`` give equal codes / rows;
``build_luts`` int8 entries are equal and ``base`` / ``inv_multiplier``
agree to 1e-6 relative (float lookup tables to 1e-5: summation order);
the dense LUT16 chunk scorer agrees to 1e-5.  Blocks wider than two
dimensions sum more than two rounded products, so the order of the sum
can move an entry across a rounding boundary: there an int8 entry may
differ by 1 and a float entry by one bf16 step (2^-8 relative), on at
most 0.1% of entries; chunk scores then agree to 1e-5 on >= 99.9% of
entries and to 2e-3 everywhere.  k-means++ training draws
differ between the packages, so one training run is held from the same
initial centers, to 1e-5.  ``ReorderHelper.rescore`` for float32 /
bfloat16 / residual-int8 rows agrees within 1e-5 relative on the same
candidates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_torch import config as tcfg
from scann_torch.models import base as tbase
from scann_torch.ops import ah as tah
from scann_torch.ops import kmeans as tkm
from scann_torch.ops import lut16 as tl16
from scann_torch.utils import native as tnative
from scann_tpu import config as jcfg
from scann_tpu.models import base as jbase
from scann_tpu.ops import ah as jah
from scann_tpu.ops import kmeans as jkm
from scann_tpu.ops import lut16 as jl16
from scann_tpu.utils import native as jnative
import torch_threads  # noqa: F401  (torch threads per xdist worker)

torch.backends.cuda.matmul.allow_tf32 = False


def _data(n=4000, d=32, seed=0):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((32, d)).astype(np.float32)
    x = centers[r.integers(0, 32, n)] + 0.3 * r.standard_normal((n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    resid = (x - 0.8 * centers[r.integers(0, 32, n)] / 6).astype(np.float32)
    return x.astype(np.float32), resid


@pytest.fixture(scope="module", params=[(2, 16), (4, 256), (3, 16)],
                ids=["dpb2", "dpb4_lut256", "dpb3_ragged"])
def models(request):
    """(JAX model, port model on the same JAX-trained codebook, data)."""
    dpb, cpb = request.param
    x, resid = _data()
    jm = jah.train_ah_model(jax.random.PRNGKey(3), jnp.asarray(resid), dpb,
                            clusters_per_block=cpb, iterations=4)
    tm = tah.AHModel(codebook=torch.from_numpy(np.asarray(jm.codebook)),
                     dims=jm.dims)
    assert (tm.num_blocks, tm.clusters_per_block, tm.dims_per_block,
            tm.padded_dims) == (jm.num_blocks, jm.clusters_per_block,
                                jm.dims_per_block, jm.padded_dims)
    return jm, tm, x, resid


def test_chunk_and_pad():
    x = np.random.default_rng(1).standard_normal((5, 7)).astype(np.float32)
    np.testing.assert_array_equal(tah.chunk(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(jah.chunk(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(
        tah.pad_to_blocks(torch.from_numpy(x), 4).numpy(),
        np.asarray(jah.pad_to_blocks(jnp.asarray(x), 4)))


def test_encode_and_reconstruct_equal(models):
    jm, tm, _, resid = models
    want = np.asarray(jah.encode(jnp.asarray(resid), jm))
    got = tah.encode(torch.from_numpy(resid), tm)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tah.reconstruct(got, tm).numpy(),
        np.asarray(jah.reconstruct(jnp.asarray(want), jm)))


@pytest.mark.parametrize("threshold", [0.2, 0.5])
def test_encode_noise_shaped_equal(models, threshold):
    jm, tm, x, resid = models
    want = np.asarray(jah.encode_noise_shaped(
        jnp.asarray(resid), jnp.asarray(x), jm, threshold))
    got = tah.encode_noise_shaped(torch.from_numpy(resid),
                                  torch.from_numpy(x), tm, threshold)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = np.asarray(jah.encode(jnp.asarray(resid), jm))
    assert (want != plain).mean() > 0.01     # the descent did switch codes


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
@pytest.mark.parametrize("lookup", ["int8", "float32"])
def test_build_luts_and_dense_chunk_scores(models, measure, lookup):
    jm, tm, x, resid = models
    q = x[:40]
    want = jah.build_luts(jnp.asarray(q), jm, measure, lookup)
    got = tah.build_luts(torch.from_numpy(q), tm, measure, lookup)
    if lookup == "int8":
        assert got.raw is None and got.int8.dtype == torch.int8
        diff = np.abs(got.int8.numpy().astype(np.int32)
                      - np.asarray(want.int8))
        assert diff.max() <= (0 if tm.dims_per_block == 2 else 1)
        assert (diff != 0).mean() <= 1e-3
    else:
        assert got.int8 is None
        np.testing.assert_allclose(got.raw.numpy(), np.asarray(want.raw),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.base.numpy(), np.asarray(want.base),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.inv_multiplier.numpy(),
                               np.asarray(want.inv_multiplier), rtol=1e-6)
    codes = np.asarray(jah.encode(jnp.asarray(resid[:600]), jm))
    cpb = jm.clusters_per_block
    np.testing.assert_array_equal(
        tl16.one_hot_codes(torch.from_numpy(codes), cpb).numpy(),
        np.asarray(jl16.one_hot_codes(jnp.asarray(codes), cpb, jnp.float32)))
    gs = tl16.score_codes_chunk(torch.from_numpy(codes), got, cpb).numpy()
    ws = np.asarray(jl16.score_codes_chunk(jnp.asarray(codes), want, cpb))
    close = np.isclose(gs, ws, rtol=1e-5, atol=1e-5)
    assert close.mean() >= (1.0 if tm.dims_per_block == 2 else 0.999)
    np.testing.assert_allclose(gs, ws, rtol=2e-3, atol=2e-3)


def test_training_from_same_initial_centers(monkeypatch):
    """Ten Lloyd iterations per block from the same k-means++ picks."""
    _, resid = _data(n=3000, d=12, seed=5)
    monkeypatch.setattr(jkm, "_kmeanspp_init",
                        lambda key, x, k, x_sq: x[7:7 + k])
    monkeypatch.setattr(tkm, "_kmeanspp_init",
                        lambda gen, x, k, x_sq: x[7:7 + k])
    want = jah.train_ah_model(jax.random.PRNGKey(0), jnp.asarray(resid), 2)
    got = tah.train_ah_model(torch.Generator().manual_seed(0),
                             torch.from_numpy(resid), 2)
    assert got.dims == want.dims == 12
    np.testing.assert_allclose(got.codebook.numpy(),
                               np.asarray(want.codebook), rtol=1e-5,
                               atol=1e-6)


def test_training_draws_come_from_the_generator():
    _, resid = _data(n=2000, d=8, seed=6)
    x = torch.from_numpy(resid)
    a = tah.train_ah_model(torch.Generator().manual_seed(1), x, 2)
    b = tah.train_ah_model(torch.Generator().manual_seed(1), x, 2)
    c = tah.train_ah_model(torch.Generator().manual_seed(2), x, 2)
    assert a.codebook.shape == (4, 16, 2)
    np.testing.assert_array_equal(a.codebook.numpy(), b.codebook.numpy())
    assert not np.array_equal(a.codebook.numpy(), c.codebook.numpy())


def test_host_helpers_equal():
    r = np.random.default_rng(2)
    for b in (6, 7):
        codes = r.integers(0, 16, (50, b)).astype(np.uint8)
        packed = tnative.pack4(codes)
        np.testing.assert_array_equal(packed, jnative.pack4(codes))
        np.testing.assert_array_equal(tnative.unpack4(packed, b), codes)
        np.testing.assert_array_equal(
            tnative.unpack4(packed, b),
            jnative.unpack4(packed, b).view(np.uint8))
    leaf = r.integers(0, 9, 500).astype(np.int32)
    (to, tc), (jo, jc) = (tnative.sort_by_leaf(leaf, 9),
                          jnative.sort_by_leaf(leaf, 9))
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tc, jc)
    rows = r.integers(0, 255, (500, 5)).astype(np.uint8)
    np.testing.assert_array_equal(tnative.gather_rows_i8(rows, to),
                                  jnative.gather_rows_i8(rows, jo))


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
@pytest.mark.parametrize("quantize", ["float32", "bfloat16", "int8"])
def test_reorder_helper_rescore(measure, quantize):
    x, _ = _data(n=1500, d=24, seed=8)
    r = np.random.default_rng(9)
    q = x[r.integers(0, 1500, 30)] + 0.05 * r.standard_normal((30, 24))
    q = q.astype(np.float32)
    cand = r.integers(0, 1500, (30, 40)).astype(np.int32)
    cand[r.random(cand.shape) < 0.1] = -1
    centers = x[:16].copy()
    tokens = r.integers(0, 16, 1500).astype(np.int32)
    residual = quantize == "int8"
    jh = jbase.ReorderHelper(
        jnp.asarray(x), measure,
        jcfg.ReorderConfig(reordering_num_neighbors=40, quantize=quantize),
        residual_tokens=tokens if residual else None,
        centers=centers if residual else None)
    th = tbase.ReorderHelper(
        torch.from_numpy(x), measure,
        tcfg.ReorderConfig(reordering_num_neighbors=40, quantize=quantize),
        residual_tokens=tokens if residual else None,
        centers=torch.from_numpy(centers) if residual else None)
    np.testing.assert_array_equal(
        th._db.float().numpy(), np.asarray(jh._db.astype(jnp.float32)))
    want = np.asarray(jh.rescore(jnp.asarray(q), jnp.asarray(cand),
                                 jh.state()))
    got = th.rescore(torch.from_numpy(q), torch.from_numpy(cand)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), cand < 0)
    live = cand >= 0
    # Squared L2 is ||q||^2 - 2 q.x + ||x||^2 of unit-scale terms: the
    # rounding scales with the terms, not with a near-zero distance.
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)
    if residual:
        # Non-residual int8 rows (per-dimension multipliers, as without a
        # tree), now served: equal rows and multipliers, the same scores.
        raw = jcfg.ReorderConfig(reordering_num_neighbors=40,
                                 quantize="int8", residual=False)
        jh = jbase.ReorderHelper(jnp.asarray(x), measure, raw)
        th = tbase.ReorderHelper(
            torch.from_numpy(x), measure,
            tcfg.ReorderConfig(reordering_num_neighbors=40,
                               quantize="int8", residual=False))
        np.testing.assert_array_equal(th._db.numpy(), np.asarray(jh._db))
        np.testing.assert_allclose(th._inv_mult.numpy(),
                                   np.asarray(jh._inv_mult), rtol=1e-6)
        want = np.asarray(jh.rescore(jnp.asarray(q), jnp.asarray(cand),
                                     jh.state()))
        got = th.rescore(torch.from_numpy(q),
                         torch.from_numpy(cand)).numpy()
        np.testing.assert_allclose(got[live], want[live], rtol=1e-5,
                                   atol=1e-5)
