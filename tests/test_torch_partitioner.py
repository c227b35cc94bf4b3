"""The partitioner's item-14 features in the port against scann_tpu.

Pieces, on the same inputs: AVQ's refit centers (rtol 1e-4: a batched f32
solve), the four query-spilling masks (equal), the learned spilling
threshold (rtol 1e-5: a quantile of f32 distance gaps), int8-centroid
query scores (1e-5) and their leaf ids (equal), and upper-tree
tokenization with a one-column and a SOAR two-column upper assignment
(equal ids).

Search: scann_tpu builds tree-SQ and tree-AH indexes with a hierarchical
tree, an upper tree (with its AVQ and SOAR), learned and given spilling
thresholds of each type, int8 centroids and AVQ; the port loads each and
returns the JAX searcher's ids on >= 99.9% of entries, distances within
1e-4 relative, at 6 leaves and on the full scan.  The JAX package's Tree-X
files leave out the partitioner's spilling type, threshold and upper
fan-out (its tree-AH files carry them, and the port writes them for
both): the test adds them to the JAX files' meta before the port loads
them.  Port-built indexes with these settings are held to the JAX-built
ones' recall@10 (within 0.03: the k-means draws differ) and load in
scann_tpu with the port's results."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scann_torch
import scann_tpu
from scann_torch.partitioning import kmeans_tree as tkt
from scann_tpu.partitioning import kmeans_tree as jkt
from test_torch_tree_ah import _assert_same, _clustered, _recall

torch.backends.cuda.matmul.allow_tf32 = False


def _rows(n=3000, d=32, k=40, seed=0):
    r = np.random.default_rng(seed)
    c = r.standard_normal((k, d)).astype(np.float32)
    x = (c[r.integers(0, k, n)]
         + 0.6 * r.standard_normal((n, d))).astype(np.float32)
    return x, c


@pytest.mark.parametrize("eta", [1.0, 2.0, 4.5])
def test_apply_avq(eta):
    x, c = _rows(seed=1)
    x[:5] = 0.0                              # zero rows (eta == 1 counts them)
    tokens = np.argmin(((x[:, None] - c[None]) ** 2).sum(-1), 1)
    tokens[tokens == 7] = 8                  # an empty leaf keeps its center
    max_leaf = int(np.bincount(tokens).max())
    want = jkt.KMeansTreePartitioner(
        centers=jnp.asarray(c), centers_int8=None, centers_inv_mult=None,
        query_distance="dot_product").apply_avq(x, tokens, eta, max_leaf)
    got = tkt.KMeansTreePartitioner(
        centers=torch.as_tensor(c), query_distance="dot_product").apply_avq(
            torch.as_tensor(x), tokens, eta, max_leaf)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.centers[7].numpy(), c[7])


@pytest.mark.parametrize("kind,thr", [("fixed_number", 0.0),
                                      ("additive", 0.4),
                                      ("absolute_distance", 0.7),
                                      ("multiplicative", 1.3)])
def test_spilling_mask(kind, thr):
    r = np.random.default_rng(2)
    sims = -np.sort(r.uniform(0.0, 3.0, (200, 12)), axis=1).astype(
        np.float32)
    sims[:5] = np.sort(r.standard_normal((5, 12)), axis=1)[:, ::-1]
    want = np.asarray(jkt.spilling_mask(jnp.asarray(sims), kind, thr))
    got = tkt.spilling_mask(torch.as_tensor(sims), kind, thr).numpy()
    np.testing.assert_array_equal(got, want)
    if kind != "fixed_number":
        assert not got.all() and got.any()
    with pytest.raises(ValueError):
        tkt.spilling_mask(torch.as_tensor(sims), "nearest", thr)


@pytest.mark.parametrize("kind", ["additive", "multiplicative"])
@pytest.mark.parametrize("factor", [1.0, 1.7, 3.0])
def test_learn_spilling_threshold(kind, factor):
    x, c = _rows(seed=3)
    want = jkt.learn_spilling_threshold(x, jnp.asarray(c), kind, factor, 6)
    got = tkt.learn_spilling_threshold(torch.as_tensor(x),
                                       torch.as_tensor(c), kind, factor, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # Fewer centers than the spill factor: the largest statistic.
    np.testing.assert_allclose(
        tkt.learn_spilling_threshold(torch.as_tensor(x), torch.as_tensor(c),
                                     kind, 3.0, 2),
        jkt.learn_spilling_threshold(x, jnp.asarray(c), kind, 3.0, 2),
        rtol=1e-5)


def _partitioners(c, measure, **kw):
    jkw = {k: (None if v is None else jnp.asarray(v)) if isinstance(
        v, (np.ndarray, type(None))) else v for k, v in kw.items()}
    tkw = {k: (None if v is None else torch.tensor(v)) if isinstance(
        v, (np.ndarray, type(None))) else v for k, v in kw.items()}
    jkw.setdefault("centers_int8", None)
    jkw.setdefault("centers_inv_mult", None)
    return (jkt.KMeansTreePartitioner(centers=jnp.asarray(c),
                                      query_distance=measure, **jkw),
            tkt.KMeansTreePartitioner(centers=torch.as_tensor(c),
                                      query_distance=measure, **tkw))


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_int8_centroid_query_scores(measure):
    from scann_tpu.ops import quantize as jq
    x, c = _rows(seed=4)
    sq = jq.scalar_quantize(jnp.asarray(c))
    jp, tp = _partitioners(c, measure, centers_int8=np.asarray(sq.data),
                           centers_inv_mult=np.asarray(
                               sq.inverse_multipliers))
    q = x[:300]
    want = np.asarray(jp.query_center_scores(jnp.asarray(q)))
    got = tp.query_center_scores(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ji, _ = jp.tokenize_queries(jnp.asarray(q), 5)
    ti, _ = tp.tokenize_queries(torch.as_tensor(q), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("two_columns", [False, True])
@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_upper_tree_tokenization(two_columns, measure):
    x, c = _rows(seed=5)
    r = np.random.default_rng(6)
    upper = c[r.choice(len(c), 6, replace=False)] + 0.1
    ua = np.argsort(((c[:, None] - upper[None]) ** 2).sum(-1), 1)[
        :, :2 if two_columns else 1].astype(np.int32)
    if not two_columns:
        ua = ua[:, 0]
    jp, tp = _partitioners(c, measure, upper_centers=upper, upper_assign=ua,
                           upper_leaves_to_search=2)
    q = x[:300]
    for leaves in (4, 12):
        ji, js_ = jp.tokenize_queries(jnp.asarray(q), leaves)
        ti, ts_ = tp.tokenize_queries(torch.as_tensor(q), leaves)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), rtol=1e-5,
                                   atol=1e-5)
    # Leaves outside the selected upper clusters score -inf.
    assert np.isneginf(ts_.numpy()).any() or two_columns


@pytest.fixture(scope="module")
def data():
    return _clustered(n=4000, nq=200, topics=200, seed=8)


def _tree(b, name):
    if name == "hierarchical":
        return b.tree(num_leaves=60, num_leaves_to_search=6,
                      training_sample_size=4000, hierarchical_top=6)
    tree_kw = dict(num_leaves=32, num_leaves_to_search=6,
                   training_sample_size=4000)
    extra = {"upper_tree": {}, "upper_tree_soar_avq": {},
             "spill_multiplicative": dict(
                 query_spilling_type="multiplicative"),
             "spill_additive": dict(query_spilling_type="additive",
                                    expected_spill_factor=3.0),
             "spill_absolute": dict(query_spilling_type="absolute_distance",
                                    query_spilling_threshold=-0.55),
             "spill_multiplicative_given": dict(
                 query_spilling_type="multiplicative",
                 query_spilling_threshold=1.2),
             "int8_centroids": dict(quantize_centroids=True),
             "avq": dict(avq=2.0)}[name]
    b = b.tree(**tree_kw, **extra)
    if name == "upper_tree":
        b = b.upper_tree(6, 2)
    if name == "upper_tree_soar_avq":
        b = b.upper_tree(6, 2, avq=2.0, soar_lambda=1.0)
    return b


# name -> (engine, measure)
CONFIGS = {"hierarchical": ("tree_sq", "squared_l2"),
           "upper_tree": ("tree_ah", "dot_product"),
           "upper_tree_soar_avq": ("tree_sq", "dot_product"),
           "spill_multiplicative": ("tree_sq", "squared_l2"),
           "spill_additive": ("tree_ah", "dot_product"),
           "spill_absolute": ("tree_sq", "dot_product"),
           "spill_multiplicative_given": ("tree_ah", "squared_l2"),
           "int8_centroids": ("tree_ah", "squared_l2"),
           "avq": ("tree_ah", "dot_product")}


def _build(builder_fn, db, name, seed=42, **kw):
    engine, measure = CONFIGS[name]
    b = _tree(builder_fn(db, 10, measure, **kw).set_seed(seed), name)
    if engine == "tree_sq":
        return b.score_brute_force("int8").build()
    return b.score_ah(2, anisotropic_quantization_threshold=0.2,
                      training_sample_size=4000).reorder(12).build()


def _add_partitioner_meta(path, part):
    """What the JAX package's Tree-X files leave out (its tree-AH files
    carry it)."""
    cfg_path = os.path.join(path, "scann_config.json")
    blob = json.load(open(cfg_path))
    blob["meta"].update(
        query_spilling_type=part.query_spilling_type,
        query_spilling_threshold=part.query_spilling_threshold,
        upper_leaves_to_search=part.upper_leaves_to_search)
    json.dump(blob, open(cfg_path, "w"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_built_index_search_parity(data, name, tmp_path):
    db, q = data
    js = _build(scann_tpu.builder, db, name)
    js.serialize(str(tmp_path))
    _add_partitioner_meta(str(tmp_path), js.partitioner)
    ts = scann_torch.load_searcher(str(tmp_path), device="cpu")
    jp, tp = js.partitioner, ts.partitioner
    assert tp.query_spilling_type == jp.query_spilling_type
    assert tp.query_spilling_threshold == pytest.approx(
        jp.query_spilling_threshold)
    assert tp.upper_leaves_to_search == jp.upper_leaves_to_search
    assert (tp.centers_int8 is None) == (jp.centers_int8 is None)
    assert (tp.upper_centers is None) == (jp.upper_centers is None)
    measure = CONFIGS[name][1]
    for leaves in (6, js.part_cfg.num_leaves):
        _assert_same(js.search_batched(q, leaves_to_search=leaves),
                     ts.search_batched(q, leaves_to_search=leaves), measure)


@pytest.mark.parametrize("name", ["hierarchical", "upper_tree_soar_avq",
                                  "spill_multiplicative", "int8_centroids"])
def test_port_built_recall_and_cross_load(data, name, tmp_path):
    """Recall@10 at 4 and 8 leaves, averaged over builds: the upper tree's
    six clusters move recall by up to 0.1 from one k-means draw to the
    next in either package, so it takes three seeds."""
    db, q = data
    measure = CONFIGS[name][1]
    sim = q @ db.T if measure == "dot_product" else -(
        (q ** 2).sum(1)[:, None] - 2 * q @ db.T + (db ** 2).sum(1)[None])
    truth = np.argsort(-sim, axis=1)[:, :10]
    seeds = (1, 2, 3) if name.startswith("upper") else (42,)
    rj, rt = [], []
    for seed in seeds:
        js = _build(scann_tpu.builder, db, name, seed=seed)
        ts = _build(scann_torch.builder, db, name, seed=seed, device="cpu")
        for leaves in (4, 8):
            rj.append(_recall(js.search_batched(q, leaves_to_search=leaves)[0],
                              truth))
            rt.append(_recall(ts.search_batched(q, leaves_to_search=leaves)[0],
                              truth))
    assert abs(np.mean(rt) - np.mean(rj)) <= 0.03, (rt, rj)
    if name == "hierarchical":
        assert ts.partitioner.upper_centers.shape[0] == 6
        assert ts.partitioner.num_leaves >= 60
    if name == "upper_tree_soar_avq":
        assert ts.partitioner.upper_assign.shape == (
            ts.partitioner.num_leaves, 2)
    got = ts.search_batched(q, leaves_to_search=6)
    ts.serialize(str(tmp_path))
    back = scann_tpu.load_searcher(str(tmp_path))
    assert back.partitioner.query_spilling_type == \
        ts.partitioner.query_spilling_type
    _assert_same(back.search_batched(q, leaves_to_search=6), got, measure)
