"""Typed (int8 / uint8) input datasets in the port against scann_tpu on the
CPU, and the dataset containers.

Search, on the same serialized index: scann_tpu builds a typed index
(brute force with 1 B rows, tree-SQ whose residual int8 encode casts per
chunk, Tree-X float32-mode leaves stored as exact bfloat16) and the port
loads it, rows in their dtype; ids agree on >= 99.9% of entries under the
tie rule of ROADMAP section 3 (an id counts when it is in the other
package's top 10 of the same query), distances within 1e-4 relative
(squared L2 relative to |d| + ||q||^2 + ||x||^2).

Build: a typed build of the port equals, bit for bit on the CPU, the
port's build of the same values cast to float32 (brute force and tree-SQ;
Tree-X's typed bfloat16 leaves equal a float32-cast bfloat16-leaf build),
while keeping the rows 1 B a dimension where the JAX package does; and
scann_tpu loads a port-built typed index and returns the port's results.
"""

import numpy as np
import pytest

import scann_torch
import scann_tpu
from scann_torch.data import dataset as tds
from scann_tpu.data import dataset as jds
import torch_threads  # noqa: F401  (torch threads per xdist worker)

ID_AGREE, DIST_RTOL = 0.999, 1e-4
TREE = dict(num_leaves=12, num_leaves_to_search=4, training_sample_size=2000)
# (engine, dtype, measure): brute force and tree-SQ under both measures,
# Tree-X bf16 leaves under squared L2.
KINDS = [(e, t, m) for e in ("brute_force", "tree_sq")
         for t in ("uint8", "int8") for m in ("dot_product", "squared_l2")]
KINDS += [("tree_bf16", t, "squared_l2") for t in ("uint8", "int8")]


def _typed(dtype, n=2400, d=24, nq=48, seed=5):
    r = np.random.default_rng(seed)
    c = r.uniform(-60, 60, (20, d))
    x = c[r.integers(0, 20, n)] + 12 * r.standard_normal((n, d))
    q = c[r.integers(0, 20, nq)] + 12 * r.standard_normal((nq, d))
    off = 128 if dtype == "uint8" else 0
    lo, hi = (0, 255) if dtype == "uint8" else (-127, 127)
    db = np.clip(np.round(x + off), lo, hi).astype(dtype)
    return db, (q + off).astype(np.float32)


@pytest.fixture(scope="module")
def corpora():
    return {t: _typed(t) for t in ("uint8", "int8")}


def _builder(pkg, db, engine, measure):
    kw = {} if pkg is scann_tpu else {"device": "cpu"}
    b = pkg.builder(db, 10, measure, **kw)
    if engine == "brute_force":
        return b.score_brute_force()
    b = b.tree(**TREE)
    return b.score_brute_force("int8" if engine == "tree_sq" else "float32")


def assert_same(want, got, measure, q, db):
    (wi, wd), (gi, gd) = want, got
    assert gi.shape == wi.shape
    found = (wi[:, :, None] == gi[:, None, :]).any(-1)
    assert found.mean() >= ID_AGREE, found.mean()
    same = (gi == wi) & (wi >= 0)
    scale = np.abs(wd)
    if measure == "squared_l2":
        x = db.astype(np.float64)
        scale = scale + (q ** 2).sum(1)[:, None] + (
            x[np.maximum(wi, 0)] ** 2).sum(-1)
    err = np.abs(gd[same] - wd[same])
    assert np.all(err <= DIST_RTOL * scale[same] + 1e-6), err.max()


def _rows(s):
    return s._db if hasattr(s, "_db") else s.slot_rows


@pytest.mark.parametrize("engine,dtype,measure", KINDS)
def test_jax_typed_index_searches_alike(corpora, engine, dtype, measure,
                                        tmp_path):
    db, q = corpora[dtype]
    js = _builder(scann_tpu, db, engine, measure).build()
    js.serialize(str(tmp_path))
    ts = scann_torch.load_searcher(str(tmp_path), device="cpu")
    want_dtype = {"brute_force": dtype, "tree_sq": "int8",
                  "tree_bf16": "bfloat16"}[engine]
    assert str(_rows(ts).dtype) == f"torch.{want_dtype}"
    assert str(np.asarray(_rows(js)).dtype) == want_dtype
    assert_same(js.search_batched(q), ts.search_batched(q), measure, q, db)


@pytest.mark.parametrize("engine,dtype,measure", KINDS)
def test_port_typed_build_equals_float_cast_build(corpora, engine, dtype,
                                                  measure, tmp_path):
    db, q = corpora[dtype]
    ts = _builder(scann_torch, db, engine, measure).build()
    if engine == "tree_bf16":
        # Typed float32-mode leaves are exact bfloat16: the float32-cast
        # twin is the bfloat16-leaf build of the same values.
        cast = (scann_torch.builder(db.astype(np.float32), 10, measure,
                                    device="cpu")
                .tree(**TREE).score_brute_force("bfloat16").build())
    else:
        cast = _builder(scann_torch, db.astype(np.float32), engine,
                        measure).build()
    if engine == "brute_force":
        assert _rows(ts).element_size() == 1
        np.testing.assert_array_equal(_rows(ts).numpy(), db)
    else:
        np.testing.assert_array_equal(_rows(ts).float().numpy(),
                                      _rows(cast).float().numpy())
    got = ts.search_batched(q)
    want = cast.search_batched(q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    ts.serialize(str(tmp_path))
    back = scann_tpu.load_searcher(str(tmp_path))
    assert_same(got, back.search_batched(q), measure, q, db)


def test_typed_rule_follows_the_jax_factory(corpora):
    """The typed rows are kept exactly where the JAX factory keeps them;
    a reorder, AH, cosine or bfloat16 brute force casts to float32."""
    from scann_torch import factory
    db, _ = corpora["uint8"]
    cases = {
        "bf": (lambda b: b.score_brute_force(), True),
        "bf_int8": (lambda b: b.score_brute_force("int8"), False),
        "bf_bf16": (lambda b: b.score_brute_force("bfloat16"), False),
        "tree_sq": (lambda b: b.tree(**TREE).score_brute_force("int8"),
                    True),
        "reorder": (lambda b: b.score_brute_force().reorder(20), False),
        "ah": (lambda b: b.score_ah(2), False),
        "pca": (lambda b: b.score_brute_force().pca(8, None), False),
    }
    for name, (make, typed) in cases.items():
        config = make(scann_torch.builder(db, 10, "dot_product",
                                          device="cpu")).create_config()
        jconfig = make(scann_tpu.builder(db, 10, "dot_product")
                       ).create_config()
        assert config.to_json() == jconfig.to_json(), name
        assert factory.typed_ok(db, config) is typed, name
    cos = scann_torch.builder(db, 10, "cosine", device="cpu"
                              ).score_brute_force().create_config()
    assert not factory.typed_ok(db, cos)
    s = scann_torch.builder(db, 10, "dot_product", device="cpu"
                            ).score_brute_force().reorder(20).build()
    assert s._db.dtype.is_floating_point


def test_dense_dataset_and_metadata(corpora):
    db, q = corpora["uint8"]
    for norm in ("none", "unitl2norm"):
        t = tds.DenseDataset(db, normalization=norm)
        j = jds.DenseDataset(db, normalization=norm)
        assert t.data.dtype == j.data.dtype and len(t) == len(j)
        np.testing.assert_array_equal(t.data, j.data)
        t.append(db[:3])
        j.append(db[:3])
        np.testing.assert_array_equal(t.data, j.data)
        assert t.dimensionality == db.shape[1]
    with pytest.raises(ValueError, match="docids"):
        tds.DenseDataset(db, docids=["a"])
    withids = tds.DenseDataset(db[:4], docids=list("abcd"))
    with pytest.raises(ValueError, match="requires them"):
        withids.append(db[:1])
    withids.append(db[:1], docids=["e"])
    assert withids.docid_for_index(4) == "e"
    # A DenseDataset without docids builds as its rows do, typed kept.
    s = scann_torch.builder(tds.DenseDataset(db), 10, "squared_l2",
                            device="cpu").score_brute_force().build()
    assert s._db.element_size() == 1
    idx, _ = s.search_batched(q)
    plain = scann_torch.builder(db, 10, "squared_l2", device="cpu"
                                ).score_brute_force().build()
    np.testing.assert_array_equal(idx, plain.search_batched(q)[0])
    # A DenseDataset's docids serve as the searcher's (ROADMAP item 15).
    ws = scann_torch.builder(tds.DenseDataset(db[:5], docids=list("abcde")),
                             3, "squared_l2", device="cpu"
                             ).score_brute_force().build()
    assert ws.docids == list("abcde")
    assert ws.search(db[2].astype(np.float32))[0][0] == "c"
    payloads = [f"row {i}" for i in range(len(db))]
    s.set_metadata(tds.MetadataGetter(payloads))
    meta = s.metadata_for(np.where(np.arange(10) % 4 == 0, -1, idx[0]))
    assert meta[0] is None and meta[1] == payloads[idx[0][1]]
    assert tds.MetadataGetter().batch_get([1, 2]) == [None, None]
    js = scann_tpu.builder(db, 10, "squared_l2").score_brute_force().build()
    js.set_metadata(jds.MetadataGetter(payloads))
    jidx = js.search_batched(q)[0]
    np.testing.assert_array_equal(js.metadata_for(jidx),
                                  s.metadata_for(jidx))
    with pytest.raises(ValueError, match="set_metadata"):
        plain.metadata_for(idx)
