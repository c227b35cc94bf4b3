"""scann_torch ops against scann_tpu ops on the same numpy inputs:
distances, exact top-k (including JAX's lower-index-first tie rule),
k-means assignment and one Lloyd step from the same initial centers, the
per-row int8 quantizer, and bf16 rounding.

Tolerances: float32 results within rtol 1e-5 (summation order differs);
ids equal (ties are broken identically)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_torch.models import base as tbase
from scann_torch.ops import distance as tdist
from scann_torch.ops import kmeans as tkm
from scann_torch.ops import topk as ttopk
from scann_tpu.models import base as jbase
from scann_tpu.ops import distance as jdist
from scann_tpu.ops import kmeans as jkm
from scann_tpu.ops import topk as jtopk
import torch_threads  # noqa: F401  (torch threads per xdist worker)

torch.backends.cuda.matmul.allow_tf32 = False


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_similarity(measure):
    r = _rng()
    q = r.standard_normal((17, 24)).astype(np.float32)
    x = r.standard_normal((300, 24)).astype(np.float32)
    want = np.asarray(jdist.similarity(jnp.asarray(q), jnp.asarray(x),
                                       measure))
    got = tdist.similarity(torch.from_numpy(q), torch.from_numpy(x),
                           measure).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for m in ("dot_product", "squared_l2", "cosine"):
        np.testing.assert_array_equal(
            tdist.similarity_to_user_distance(torch.from_numpy(got),
                                              m).numpy(),
            np.asarray(jdist.similarity_to_user_distance(jnp.asarray(got),
                                                         m)))


def _with_ties(r, shape):
    """Scores with many exact ties (and -inf entries)."""
    s = r.integers(-5, 5, shape).astype(np.float32) / 4
    s[r.random(shape) < 0.1] = -np.inf
    return s


@pytest.mark.parametrize("k", [1, 7, 40])
def test_top_k_and_chunk_top_k_tie_order(k):
    r = _rng(1)
    s = _with_ties(r, (9, 33))
    valid = r.random(s.shape) < 0.8
    jv, ji = jtopk.top_k(jnp.asarray(s), k)
    tv, ti = ttopk.top_k(torch.from_numpy(s), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jv, ji = jtopk.chunk_top_k(jnp.asarray(s), k, valid=jnp.asarray(valid))
    tv, ti = ttopk.chunk_top_k(torch.from_numpy(s), k,
                               valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32


def test_merge_top_k():
    r = _rng(2)
    va, vb = _with_ties(r, (6, 10)), _with_ties(r, (6, 12))
    ia = r.integers(0, 1000, va.shape).astype(np.int32)
    ib = r.integers(0, 1000, vb.shape).astype(np.int32)
    jv, ji = jtopk.merge_top_k(*map(jnp.asarray, (va, ia, vb, ib)), 10)
    tv, ti = ttopk.merge_top_k(*map(torch.from_numpy, (va, ia, vb, ib)), 10)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("block_rows", [None, 64])
def test_kmeans_assign(block_rows):
    r = _rng(3)
    x = r.standard_normal((500, 16)).astype(np.float32)
    c = r.standard_normal((20, 16)).astype(np.float32)
    ja, jd = jkm.assign(jnp.asarray(x), jnp.asarray(c),
                        block_rows=block_rows)
    ta, td = tkm.assign(torch.from_numpy(x), torch.from_numpy(c),
                        block_rows=block_rows)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("spherical", [False, True])
def test_lloyd_step_from_same_centers(spherical):
    """One Lloyd iteration (assign, update, reseed undersized clusters)
    given the same initial centers; min_size 12 forces reseeding."""
    r = _rng(4)
    x = r.standard_normal((400, 12)).astype(np.float32)
    c0 = x[r.choice(400, 25, replace=False)]
    k, min_size = 25, 12

    xj, cj = jnp.asarray(x), jnp.asarray(c0)
    a, sq = jkm.assign(xj, cj)
    new, counts = jkm._update_centers(xj, a, k)
    new = jnp.where((counts > 0)[:, None], new, cj)
    new, changed = jkm._reseed_bad_centers(xj, new, a, counts, sq, min_size)
    if spherical:
        new = new / jnp.maximum(jnp.linalg.norm(new, axis=-1,
                                                keepdims=True), 1e-20)
    assert bool(changed)
    xt = torch.from_numpy(x)
    got = tkm.lloyd_step(xt, torch.from_numpy(c0), (xt * xt).sum(-1), k,
                         min_size, spherical=spherical)
    np.testing.assert_allclose(got.numpy(), np.asarray(new), rtol=1e-5,
                               atol=1e-6)


def test_row_quantize():
    r = _rng(5)
    delta = r.standard_normal((64, 20)).astype(np.float32) * 0.1
    delta[3] = 0.0
    jq, js = jbase._row_quantize(jnp.asarray(delta))
    tq, ts = tbase._row_quantize(torch.from_numpy(delta))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_bf16_rounding_matches_xla():
    """Queries round to bf16 before the int8 scorer: torch's cast must round
    to nearest even exactly as XLA's does, halfway cases included."""
    r = _rng(6)
    x = r.standard_normal(4096).astype(np.float32)
    bits = x.view(np.uint32)
    halfway = ((bits & ~np.uint32(0xFFFF)) | np.uint32(0x8000)).view(
        np.float32)
    for v in (x, halfway):
        want = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(
            jnp.float32))
        got = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, want)
