"""Card tests of the selection kernel (csrc/pruned_merge.cu, the custom op
``pruned_merge``; marker ``cuda``, they skip without a card).  The kernel
equals the plain merge (``pruned_scan.merge_ids_torch``: merge_candidates,
the id lookup and the squared-L2 restore) bit for bit, in values and ids,
at the three benchmark cells' shapes and on the cases that stress its
selection: equal values across hot and cold columns, an allowlist that
kills most slots, invalid pairs, with and without a pair bias and the
restore, k above the candidate count, invert_small's all-hot batches, and
k at the kernel's limit (one above it keeps the plain merge and launches
nothing).  A pruned search makes no host-synchronising call, launches the
kernel once a batch, and answers as the plain merge does.  On a machine
with a card (no JAX needed)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_merge.py
"""

import types

import numpy as np
import pytest
import torch

import scann_torch
from scann_torch.ops import pruned_scan as ps
from scann_torch.tools.merge_breakdown import SHAPES, merge_case
import torch_threads  # noqa: F401  (torch threads per xdist worker)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _candidates(args, kw, k_fetch):
    """``pruned_scan.candidates`` on merge_case's operands."""
    (packed, work_active, pair_gid, pair_row, sel, valid, tile_start,
     ntiles, dpid, pair_bias, q_norm) = args
    layout = ps.PrunedLayout(tile_start, ntiles, kw["max_ntiles"],
                             int(ntiles.sum()), dpid, None, kw["tile"])
    plan = types.SimpleNamespace(work_active=work_active, pair_gid=pair_gid,
                                 pair_row=pair_row)
    assert q_norm is None
    return ps.candidates(layout, plan, packed, sel, valid, k_fetch,
                         pair_bias, kw["hot"])


def _hold(args, kw, k_fetch, launches=1, via_candidates=False):
    """The op (or ``candidates``) on the card against the plain merge on
    the card and, below a million packed words, on the CPU; the launch
    counter rises by ``launches``."""
    before = ps.launches_select
    if via_candidates:
        got = _candidates(args, kw, k_fetch)
    else:
        got = ps.select_merge(*args, k_fetch=k_fetch, **kw)
    want = ps.merge_ids_torch(*args, k_fetch=k_fetch, **kw)
    torch.cuda.synchronize()
    assert ps.launches_select == before + launches
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if args[0].numel() < 1 << 20:
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        want = ps.merge_ids_torch(*cpu, k_fetch=k_fetch, **kw)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    return got


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_merge_bit_equal_at_the_cells_shapes(cuda, name):
    b, l, mnt, tile, kpg, k, bias, l2 = SHAPES[name]
    args, kw = merge_case(1, b, l, mnt, tile, kpg, bias=bias, l2=l2)
    vals, ids = _hold(args, kw, k)
    assert vals.shape == (b, min(k, ps.merge_width(
        l, kw["hot"], mnt, kpg * tile // 32, tile // 32)))
    assert (ids >= 0).float().mean() > 0.5


# (queries, leaves, tiles, tile, kpg, k_fetch, options): the three shapes'
# stress cases at 2,000 queries.
_CASES = {
    "ties_glove": (2000, 100, 2, 512, 8, 100, dict(coarse=True,
                                                   bias=False)),
    "ties_sift": (2000, 8, 4, 256, 4, 40, dict(coarse=True, l2=True,
                                               bias=False)),
    "allowlist_kills_most": (2000, 40, 4, 512, 8, 300, dict(p_dead=0.97)),
    "allowlist_sift": (2000, 8, 4, 256, 4, 40, dict(p_dead=0.97, l2=True,
                                                    bias=False)),
    "invalid_pairs": (2000, 100, 2, 512, 8, 100, dict(p_invalid=0.6)),
    "no_bias": (2000, 100, 2, 512, 8, 100, dict(bias=False)),
    "bias_and_l2": (2000, 40, 4, 512, 8, 300, dict(l2=True)),
    "k_above_n": (500, 3, 1, 256, 4, 200, dict(coarse=True)),
    "invert_small": (16, 8, 4, 512, 8, 100, dict(coarse=True)),
    "invert_small_sift": (16, 8, 4, 256, 4, 40, dict(l2=True, bias=False)),
    "one_query_all_hot": (1, 100, 2, 512, 8, 300, dict()),
    "k_at_the_limit": (300, 100, 2, 512, 8, ps._SELECT_MAX_K,
                       dict(coarse=True)),
    "widest_row": (200, 20, 16, 512, 16, 500, dict(coarse=True)),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_merge_bit_equal_on_hard_cases(cuda, name):
    b, l, mnt, tile, kpg, k, opts = _CASES[name]
    args, kw = merge_case(sorted(_CASES).index(name), b, l, mnt, tile, kpg,
                          **opts)
    if name.startswith("invert_small") or name == "one_query_all_hot":
        assert kw["hot"] == l
    n = ps.merge_width(l, kw["hot"], mnt, kpg * tile // 32, tile // 32)
    if name == "k_above_n":
        assert k > n
    vals, ids = _hold(args, kw, k)
    if name.startswith("allowlist"):
        assert (ids < 0).float().mean() > 0.2      # most slots died
    if name.startswith("ties"):
        # Equal values within a row, hot and cold columns among them.
        assert (vals[:, 1:] == vals[:, :-1]).float().mean() > 0.5


def test_merge_one_above_the_limit_keeps_the_plain_merge(cuda):
    args, kw = merge_case(5, 300, 100, 2, 512, 8, coarse=True)
    n = ps.merge_width(100, kw["hot"], 2, 128, 16)
    for k, launches in ((ps._SELECT_MAX_K, 1), (ps._SELECT_MAX_K + 1, 0)):
        assert n > k
        assert ps.merge_path(k, n, 128, 16, 2) == ("select" if launches
                                                   else "plain")
        if launches:
            _hold(args, kw, k)
        _hold(args, kw, k, launches, via_candidates=True)
    with pytest.raises(ValueError, match="unsupported merge"):
        ps.select_merge(*args, k_fetch=ps._SELECT_MAX_K + 1, **kw)


def _searcher(engine, **tree):
    r = np.random.default_rng(0)
    c = r.standard_normal((64, 48))
    db = (c[r.integers(0, 64, 20000)]
          + 0.3 * r.standard_normal((20000, 48))).astype(np.float32)
    q = (c[r.integers(0, 64, 300)]
         + 0.3 * r.standard_normal((300, 48))).astype(np.float32)
    measure = "squared_l2" if engine == "tree_sq" else "dot_product"
    b = scann_torch.builder(db, 10, measure).tree(
        num_leaves=40, num_leaves_to_search=6, training_sample_size=10000,
        **tree)
    if engine == "tree_sq":
        b = b.score_brute_force(quantize="int8").reorder(40)
    else:
        b = b.score_ah(2, anisotropic_quantization_threshold=0.2,
                       training_sample_size=10000).reorder(100)
    return b.build(), q


@pytest.mark.parametrize("engine", ["tree_ah", "tree_sq", "soar"])
def test_pruned_search_launches_once_a_batch_and_never_waits(cuda, engine,
                                                            monkeypatch):
    tree = dict(soar_lambda=1.5, overretrieve_factor=2.0) \
        if engine == "soar" else {}
    s, q = _searcher("tree_sq" if engine == "tree_sq" else "tree_ah",
                     **tree)
    allow = np.random.default_rng(1).random(s.n_points) < 0.3
    s.search_batched(q)                     # the lazy layout, the builds
    kw = dict(leaves_to_search=6, pre_reorder_num_neighbors=100)
    for restrict in (None, allow):
        before = ps.launches_select
        got = s.search_batched(q, restrict_allowlist=restrict, **kw)
        got_small = s.search_batched(q[:16], restrict_allowlist=restrict,
                                     **kw)          # invert_small
        assert ps.launches_select == before + 2
        with monkeypatch.context() as m:
            m.setattr(ps, "_SELECT_MAX_N", 0)       # the plain merge
            want = s.search_batched(q, restrict_allowlist=restrict, **kw)
            want_small = s.search_batched(q[:16], restrict_allowlist=restrict,
                                          **kw)
        assert ps.launches_select == before + 2
        for g, w in ((got, want), (got_small, want_small)):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
    qd = torch.as_tensor(q, device=cuda)
    torch.cuda.synchronize()
    before = ps.launches_select
    torch.cuda.set_sync_debug_mode("error")
    try:
        vals, ids = s._pruned_select(qd, 100, 6, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert ps.launches_select == before + 1
    assert vals.shape[0] == ids.shape[0] == q.shape[0]
