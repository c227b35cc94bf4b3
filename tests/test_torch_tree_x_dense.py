"""Tree-X with dense leaves against scann_tpu on the CPU: float32 and
bfloat16 leaves, global-int8 leaves (the layout an int8 index takes when
the pruned tree-SQ layout is declined) and the single-leaf tree, under dot
product and squared L2.

Search, on the same serialized index, both directions, to the bar of
tests/test_torch_brute_force.py (>= 99.9% of the top-10 ids found in
the other package's top 10,
distances within 1e-4 relative, squared L2 relative to |d| + ||q||^2 +
||x||^2): the index scann_tpu builds, loaded by both packages, and the
index the port builds, loaded by scann_tpu.  Every search here is the
dense masked scan; the JAX-built index's take 3 of 16 leaves, the
port-built one's all of them.

Build, statistically: the port's k-means draws differ from jax.random's,
so a port-built index's recall@10 against the exact truth is held to the
JAX-built index's on the same data, within 1 pt (400 queries searching 5
of 16 leaves)."""

import numpy as np
import pytest

import scann_torch
import scann_tpu
from scann_torch.models import tree_x as ttx
from scann_tpu.models import tree_x as jtx
from tests.test_torch_brute_force import assert_same
import torch_threads  # noqa: F401  (torch threads per xdist worker)

# kind -> (quantize, num_leaves, pruned layout declined)
KINDS = {"float32": ("float32", 16, False), "bf16": ("bfloat16", 16, False),
         "global_int8": ("int8", 16, True), "single_leaf": ("int8", 1, False)}


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(21)
    c = r.standard_normal((40, 24))
    db = c[r.integers(0, 40, 2500)] + 0.3 * r.standard_normal((2500, 24))
    q = c[r.integers(0, 40, 450)] + 0.3 * r.standard_normal((450, 24))
    return db.astype(np.float32), q.astype(np.float32)


def _build(pkg, db, measure, kind, monkeypatch):
    quantize, leaves, declined = KINDS[kind]
    if declined:
        # The pruned layout declines (a leaf over its tile budget): both
        # packages then take dense rows with global int8 multipliers.
        monkeypatch.setattr(jtx.TreeXSearcher, "_build_sq",
                            lambda self, *a: False)
        monkeypatch.setattr(ttx.TreeXSearcher, "_build_sq",
                            lambda self, *a: False)
    kw = {} if pkg is scann_tpu else {"device": "cpu"}
    s = (pkg.builder(db, 10, measure, **kw)
         .tree(num_leaves=leaves, num_leaves_to_search=min(3, leaves),
               training_sample_size=2500)
         .score_brute_force(quantize).build())
    monkeypatch.undo()
    assert not s._sq_mode
    return s


def _search(s, q, all_leaves):
    n = s.part_cfg.num_leaves
    return s.search_batched(q, leaves_to_search=n if all_leaves
                            else min(3, n))


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jax_built_index_searches_alike(data, measure, kind, tmp_path,
                                        monkeypatch):
    db, q = data[0], data[1][:50]
    _build(scann_tpu, db, measure, kind, monkeypatch).serialize(
        str(tmp_path))
    js = scann_tpu.load_searcher(str(tmp_path))
    ts = scann_torch.load_searcher(str(tmp_path), device="cpu")
    assert str(ts.slot_rows.dtype) == f"torch.{KINDS[kind][0]}"
    assert_same(_search(js, q, False), _search(ts, q, False), measure, q, db)


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_built_index_searches_alike(data, measure, kind, tmp_path,
                                         monkeypatch):
    db, q = data[0], data[1][:50]
    ts = _build(scann_torch, db, measure, kind, monkeypatch)
    if KINDS[kind][0] == "int8":
        assert ts._inv_mult is not None
    ts.serialize(str(tmp_path))
    js = scann_tpu.load_searcher(str(tmp_path))
    assert not js._sq_mode
    assert_same(_search(ts, q, True), _search(js, q, True), measure, q, db)


def _recall(idx, truth):
    return np.mean([len(set(idx[i]) & set(truth[i])) / truth.shape[1]
                    for i in range(len(truth))])


@pytest.mark.parametrize("kind", ["float32", "global_int8"])
def test_build_recall_matches_the_jax_build(data, kind, monkeypatch):
    db, q = data[0], data[1][50:]
    truth = np.argsort(-(q @ db.T), axis=1)[:, :10]
    rj = _recall(_build(scann_tpu, db, "dot_product", kind, monkeypatch)
                 .search_batched(q, leaves_to_search=5)[0], truth)
    rt = _recall(_build(scann_torch, db, "dot_product", kind, monkeypatch)
                 .search_batched(q, leaves_to_search=5)[0], truth)
    assert abs(rt - rj) <= 0.01, (rt, rj)
