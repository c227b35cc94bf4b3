"""chip_smoke.py's per-query pre_reorder_num_neighbors check, driven on a
small CPU SOAR index whose rows come in exact triplicates: every score
ties two others, so each query's 10th candidate ties its 11th and the two
budgets may keep different ones of a tied triple.  Rows planted in the
searches' output stand for the rescore's rounding at another width."""

import numpy as np
import pytest
import torch

import chip_smoke
import scann_torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

K, K_SMALL, K_LARGE, LEAVES = 5, 10, 40, 4


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(3)
    db = np.repeat(rng.standard_normal((2000, 32)).astype(np.float32), 3,
                   axis=0)
    queries = rng.standard_normal((40, 32)).astype(np.float32)
    s = (scann_torch.builder(db, K, "dot_product", device="cpu")
         .tree(num_leaves=16, num_leaves_to_search=LEAVES,
               training_sample_size=6000, soar_lambda=1.5)
         .score_ah(2, anisotropic_quantization_threshold=0.2)
         .reorder(K_LARGE).build())
    base_i, _ = s.search_batched(queries, leaves_to_search=LEAVES)
    return s, queries, torch.from_numpy(queries), base_i


def _check(index):
    s, queries, q, base_i = index
    return chip_smoke.check_k_pre_rows(torch, s, queries, q, base_i,
                                       K_SMALL, K_LARGE, LEAVES)


def _alter_row(monkeypatch, searcher, row):
    """The per-query search returns another id in ``row``'s first column."""
    search = searcher.search_batched

    def altered(queries, **kw):
        idx, dist = search(queries, **kw)
        if isinstance(kw.get("pre_reorder_num_neighbors"), np.ndarray):
            idx = idx.copy()
            idx[row, 0] = 10 ** 6
        return idx, dist
    monkeypatch.setattr(searcher, "search_batched", altered)


def test_triplicated_rows_tie_at_the_cut(index):
    ties, differ, _ = _check(index)
    assert ties == index[1].shape[0] // 2
    assert differ <= ties


def test_a_row_that_differs_at_a_tie_passes(index, monkeypatch):
    _alter_row(monkeypatch, index[0], 0)
    assert _check(index)[1] >= 1


@pytest.mark.parametrize("row", [0, 1])
def test_a_row_that_differs_without_a_tie_fails(index, monkeypatch, row):
    # Row 0 asks for the small budget: with no tie it must match the
    # scalar search.  Row 1 asks for the searcher's own and must match its
    # plain search whatever the ties.
    _alter_row(monkeypatch, index[0], row)
    monkeypatch.setattr(chip_smoke, "cut_at_a_tie", lambda *a: False)
    with pytest.raises(AssertionError, match="pre_reorder_num_neighbors"):
        _check(index)


def _same_candidates_row(index):
    """An even row whose best K_SMALL candidates are the same, in the same
    order, at both budgets."""
    s, queries, q, _ = index
    rows = np.arange(0, queries.shape[0], 2)
    (va, da), (vb, db_) = chip_smoke.cut_lists(torch, s, q, rows, K_SMALL,
                                               K_LARGE, LEAVES)
    same = [j for j in range(len(rows))
            if np.array_equal(da[j], db_[j][:K_SMALL])
            and np.array_equal(va[j], vb[j][:K_SMALL])]
    assert same
    return rows[same[0]]


def test_a_row_that_differs_by_rounding_passes(index, monkeypatch):
    # The first two results of a row trade places, their distances 1e-7
    # apart, as the rescore at another width may round them.
    s, queries = index[0], index[1]
    row = _same_candidates_row(index)
    ids, dist = s.search_batched(queries, pre_reorder_num_neighbors=K_SMALL,
                                 leaves_to_search=LEAVES)
    a, b = ids[row, :2]
    v = dist[row, 0]
    w = np.float32(v * (1 + 1e-7))
    search = s.search_batched

    def planted(queries, **kw):
        idx, dist = search(queries, **kw)
        k_pre = kw.get("pre_reorder_num_neighbors")
        put = (([b, a], [w, v]) if isinstance(k_pre, np.ndarray)
               else ([a, b], [v, w]) if k_pre == K_SMALL else None)
        if put is not None:
            idx, dist = idx.copy(), dist.copy()
            idx[row, :2], dist[row, :2] = put
        return idx, dist
    monkeypatch.setattr(s, "search_batched", planted)
    monkeypatch.setattr(chip_smoke, "cut_at_a_tie", lambda *a: False)
    assert _check(index)[2] == 1


_NEAR = [0.5, 0.5000001, 0.25]


@pytest.mark.parametrize("da,ib,db_,want", [
    # The first two trade places, 1e-7 apart.
    (_NEAR, [1, 0, 2], [0.5, 0.5000001, 0.25], True),
    # The same swap between distances 1e-4 apart.
    ([0.5, 0.5001, 0.25], [1, 0, 2], [0.5, 0.5001, 0.25], False),
    # Two ids 0.25 apart trade places, each taking the other's distance.
    ([0.5, 0.25, 0.1], [1, 0, 2], [0.5, 0.25, 0.1], False),
    # The last result is another candidate, 1e-7 away.
    (_NEAR, [0, 1, 3], [0.5, 0.5000001, 0.2500001], True),
    # The last result is no candidate.
    (_NEAR, [0, 1, 9], [0.5, 0.5000001, 0.25], False),
])
def test_equal_up_to_rounding(da, ib, db_, want):
    assert chip_smoke.equal_up_to_rounding(
        np.array([0, 1, 2]), np.array(da, np.float32), np.array(ib),
        np.array(db_, np.float32), np.arange(5)) is want


@pytest.mark.parametrize("vb,db_,want", [
    # The 3rd score ties the large budget's 4th, which kept the other one.
    ([5, 4, 3, 3], [0, 1, 3, 2], True),
    # Equal 3rd scores, but nothing past them ties.
    ([5, 4, 3, 2], [0, 1, 3, 2], False),
    # Different 3rd scores.
    ([5, 4, 3.5, 3], [0, 1, 2, 3], False),
    # A tie at the cut, but the candidates above it differ.
    ([5, 4, 3, 3], [0, 9, 2, 3], False),
])
def test_cut_at_a_tie(vb, db_, want):
    va, da = np.array([5, 4, 3], np.float32), np.arange(3)
    assert chip_smoke.cut_at_a_tie(va, da, np.array(vb, np.float32),
                                   np.array(db_)) is want
