"""Stacked (additive) quantization, VARIABLE_CHUNK product codes and the
single-leaf AH tree in the port, against scann_tpu on the CPU.

Ops: uniform variable widths reproduce the fixed chunking bit for bit
(the port's counterpart of tests/test_variable_chunks.py); make_block_dims
equals the JAX table; on JAX-trained codebooks the port's encodings
(plain, noise-shaped, stacked) equal the JAX ones and its reconstructions
and LUTs agree within 1e-6.

Search, on the same serialized index (scann_tpu builds, the port loads):
stacked, variable-chunk and single-leaf indexes in int8 / float32 /
reconstruct lookup, with a float32 reorder at the tree-AH parity budget
of 30: ids >= 99.9% found in the other top 10, distances within 1e-4
relative (squared L2 relative to |d| + ||q||^2 + ||x||^2).  The routes
are the JAX package's: reconstruct mode takes the pruned path (K2) under
a tree of more than one leaf; stacked and variable-chunk LUT modes, and
every one-leaf tree, take the dense scan.  Stacked LUT modes under
squared L2 raise ValueError in both packages.  scann_tpu loads the
port-built index of each kind and returns the port's results."""

import dataclasses

import numpy as np
import pytest
import torch

import scann_torch
import scann_tpu
from scann_torch.ops import ah as tah
from scann_torch.ops import stacked as tst
import torch_threads  # noqa: F401  (torch threads per xdist worker)

ID_AGREE, DIST_RTOL = 0.999, 1e-4
TREE = dict(num_leaves=8, num_leaves_to_search=3, training_sample_size=2000)
WIDTHS = [4, 4, 2, 2, 2, 2]          # 16 dimensions


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(8)
    c = r.standard_normal((40, 16))
    db = c[r.integers(0, 40, 2000)] + 0.35 * r.standard_normal((2000, 16))
    q = c[r.integers(0, 40, 40)] + 0.35 * r.standard_normal((40, 16))
    return db.astype(np.float32), q.astype(np.float32)


def test_uniform_variable_widths_equal_fixed_chunks():
    sample = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3000, 24)).astype(np.float32))
    fixed = tah.train_ah_model(torch.Generator().manual_seed(7), sample, 2)
    var = tah.train_ah_model(torch.Generator().manual_seed(7), sample, 2,
                             variable_dims_per_block=[2] * 12)
    assert var.block_dims is not None
    np.testing.assert_array_equal(fixed.codebook.numpy(),
                                  var.codebook.numpy())
    v = sample[:500]
    np.testing.assert_array_equal(tah.encode(v, fixed).numpy(),
                                  tah.encode(v, var).numpy())
    np.testing.assert_allclose(
        tah.reconstruct(tah.encode(v, var), var).numpy(),
        tah.reconstruct(tah.encode(v, fixed), fixed).numpy(), rtol=1e-6)


def test_make_block_dims_matches_jax():
    from scann_tpu.ops import ah as jah
    for dims, widths in ((16, WIDTHS), (20, [4, 4, 4, 2, 2, 2, 2]),
                         (7, [3, 1, 3]), (5, [5])):
        np.testing.assert_array_equal(tah.make_block_dims(dims, widths),
                                      jah.make_block_dims(dims, widths))
    for bad in ([4, 4], [0, 16], [20, -4]):
        with pytest.raises(ValueError):
            tah.make_block_dims(16, bad)


def _jax_models(sample):
    import jax
    import jax.numpy as jnp
    from scann_tpu.ops import ah as jah
    from scann_tpu.ops import stacked as jst
    key = jax.random.PRNGKey(3)
    var = jah.train_ah_model(key, jnp.asarray(sample), 2, iterations=2,
                             variable_dims_per_block=WIDTHS)
    stk = jst.train_stacked(key, jnp.asarray(sample), 2, 16, 2)
    return var, stk


def test_encode_and_reconstruct_on_jax_codebooks(data):
    import jax.numpy as jnp
    from scann_tpu.ops import ah as jah
    from scann_tpu.ops import stacked as jst
    db, q = data
    jvar, jstk = _jax_models(db[:800])
    var = tah.AHModel(codebook=torch.tensor(np.asarray(jvar.codebook)),
                      dims=16, block_dims=torch.tensor(
                          np.asarray(jvar.block_dims)))
    stk = tst.StackedModel(codebooks=torch.tensor(
        np.asarray(jstk.codebooks)), dims=16)
    v = db[1500:]
    vt = torch.as_tensor(v)
    # Variable chunks: plain and noise-shaped codes, reconstruction, LUTs.
    codes = tah.encode(vt, var)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jah.encode(jnp.asarray(v), jvar)))
    shaped = tah.encode_noise_shaped(vt, vt, var, 0.2)
    jshaped = np.asarray(jah.encode_noise_shaped(jnp.asarray(v),
                                                 jnp.asarray(v), jvar, 0.2))
    assert (shaped.numpy() == jshaped).mean() >= 0.999
    np.testing.assert_allclose(
        tah.reconstruct(codes, var).numpy(),
        np.asarray(jah.reconstruct(jnp.asarray(codes.numpy()), jvar)),
        atol=1e-6)
    for measure in ("dot_product", "squared_l2"):
        got = tah.build_luts(torch.as_tensor(q), var, measure, "float32")
        want = jah.build_luts(jnp.asarray(q), jvar, measure, "float32")
        np.testing.assert_allclose(got.raw.numpy(), np.asarray(want.raw),
                                   rtol=1e-6, atol=1e-6)
    # Stacked: greedy stage codes, their sum, the dot-product LUTs.
    codes = tst.encode_stacked(vt, stk)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jst.encode_stacked(jnp.asarray(v), jstk)))
    np.testing.assert_allclose(
        tst.reconstruct_stacked(codes, stk).numpy(),
        np.asarray(jst.reconstruct_stacked(jnp.asarray(codes.numpy()),
                                           jstk)), atol=1e-6)
    np.testing.assert_allclose(
        tst.build_stacked_luts(torch.as_tensor(q), stk).numpy(),
        np.asarray(jst.build_stacked_luts(jnp.asarray(q), jstk)),
        rtol=1e-6, atol=1e-6)


def test_train_stacked_is_stagewise_greedy(data):
    db, _ = data
    x = torch.as_tensor(db)
    m = tst.train_stacked(torch.Generator().manual_seed(0), x, 3, 16, 5)
    assert m.codebooks.shape == (3, 16, 16) and m.num_stages == 3
    # Each stage lowers the reconstruction error of its greedy encoding.
    errs = [float(((x - tst.reconstruct_stacked(
        tst.encode_stacked(x, tst.StackedModel(m.codebooks[:s], 16)),
        tst.StackedModel(m.codebooks[:s], 16))) ** 2).sum())
        for s in (1, 2, 3)]
    assert errs[0] > errs[1] > errs[2]


def _config(pkg, db, measure, kind, lookup):
    kw = {} if pkg is scann_tpu else {"device": "cpu"}
    b = pkg.builder(db, 10, measure, **kw)
    if kind == "single_leaf":
        b = b.tree(num_leaves=1, num_leaves_to_search=1)
        b = b.score_ah(2, anisotropic_quantization_threshold=0.2)
    else:
        b = b.tree(**TREE)
        # Stacked: 4 full-width stages (16 dimensions / 4).
        b = (b.score_ah(4, quantization_scheme="stacked")
             if kind == "stacked"
             else b.score_ah(2, variable_dims_per_block=WIDTHS))
    config = b.reorder(30).create_config()
    return dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type=lookup))


SEARCH_CASES = [
    ("stacked", "dot_product", "int8"),
    ("stacked", "dot_product", "float32"),
    ("stacked", "dot_product", "reconstruct"),
    ("stacked", "squared_l2", "reconstruct"),
    ("variable", "dot_product", "int8"),
    ("variable", "squared_l2", "float32"),
    ("variable", "squared_l2", "reconstruct"),
    ("single_leaf", "dot_product", "int8"),
    ("single_leaf", "squared_l2", "reconstruct"),
]


def assert_same(want, got, measure, q, db):
    (wi, wd), (gi, gd) = want, got
    found = (wi[:, :, None] == gi[:, None, :]).any(-1)
    assert found.mean() >= ID_AGREE, found.mean()
    same = (gi == wi) & (wi >= 0)
    scale = np.abs(wd)
    if measure == "squared_l2":
        scale = scale + (q ** 2).sum(1)[:, None] + (
            db[np.maximum(wi, 0)] ** 2).sum(-1)
    err = np.abs(gd[same] - wd[same])
    assert np.all(err <= DIST_RTOL * scale[same] + 1e-6), err.max()


@pytest.mark.parametrize("kind,measure,lookup", SEARCH_CASES)
def test_jax_built_index_searches_alike(data, kind, measure, lookup,
                                        tmp_path):
    db, q = data
    js = scann_tpu.create_searcher(db, _config(scann_tpu, db, measure, kind,
                                               lookup))
    js.serialize(str(tmp_path))
    ts = scann_torch.load_searcher(str(tmp_path), device="cpu")
    assert ts._pruned_available == js._pruned_available == (
        lookup == "reconstruct" and kind != "single_leaf")
    leaves = (1,) if kind == "single_leaf" else (3, 8)
    for lv in leaves:
        assert_same(js.search_batched(q, leaves_to_search=lv),
                    ts.search_batched(q, leaves_to_search=lv), measure, q,
                    db)


@pytest.mark.parametrize("kind,measure,lookup", [
    ("stacked", "dot_product", "int8"),
    ("stacked", "squared_l2", "reconstruct"),
    ("variable", "dot_product", "reconstruct"),
    ("single_leaf", "dot_product", "reconstruct")])
def test_port_built_index_loads_in_jax(data, kind, measure, lookup,
                                       tmp_path):
    db, q = data
    ts = scann_torch.create_searcher(
        db, _config(scann_torch, db, measure, kind, lookup), "cpu")
    got = ts.search_batched(q)
    truth = np.argsort(-(q @ db.T) if measure == "dot_product" else
                       ((q ** 2).sum(1)[:, None] - 2 * q @ db.T
                        + (db ** 2).sum(1)), axis=1)[:, :10]
    recall = np.mean([len(set(got[0][i]) & set(truth[i])) / 10
                      for i in range(len(q))])
    assert recall >= 0.7, recall
    ts.serialize(str(tmp_path))
    back = scann_tpu.load_searcher(str(tmp_path))
    assert back.stacked == (kind == "stacked")
    assert_same(got, back.search_batched(q), measure, q, db)


def test_stacked_squared_l2_lut_modes_raise(data):
    db, _ = data
    for lookup in ("int8", "float32"):
        with pytest.raises(ValueError, match="reconstruct"):
            scann_torch.create_searcher(db, _config(
                scann_torch, db, "squared_l2", "stacked", lookup), "cpu")
        with pytest.raises(ValueError, match="reconstruct"):
            scann_tpu.create_searcher(db, _config(
                scann_tpu, db, "squared_l2", "stacked", lookup))
