"""Card tests of the plan kernels (csrc/pruned_plan.cu, the custom op
``pruned_plan``; marker ``cuda``, they skip without a card).  The plan
built on the card equals plain ``invert`` on the CPU in every WorkPlan
field, bit for bit; a pruned search's candidate selection (tree-AH through
K3, tree-SQ through K1) makes no host-synchronising call; the launch
counter rises by one for each pruned search on the card and not for a
batch small enough for ``invert_small``.  On a machine with a card (no JAX
needed)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_plan.py
"""

import numpy as np
import pytest
import torch

import scann_torch
from scann_torch.ops import pruned_lut, pruned_sq
from scann_torch.ops import pruned_scan as ps
import torch_threads  # noqa: F401  (torch threads per xdist worker)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _plan_operands(seed, b, l, nl, mnt):
    """(sel, valid, tile_start, ntiles) of b queries over l of nl leaves of
    1 to mnt tiles: a fifth of the leaves hold no pair, about 10% of the
    entries are invalid (half of those -1), rows wider than the live
    leaves are padded with invalid -1 entries, and where the batch has
    more than 4 * QG queries one leaf is in every row."""
    r = np.random.default_rng(seed)
    ntiles = r.integers(1, mnt + 1, nl).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    live = np.flatnonzero(r.random(nl) >= 0.2)
    hot = live[0] if b > 4 * ps.QG else None
    rest = live[1:] if hot is not None else live

    def row():
        k = min(l - (hot is not None), len(rest))
        ids = [r.choice(rest, k, replace=False)]
        if hot is not None:
            ids.append([hot])
        pad = l - k - (hot is not None)
        return r.permutation(np.concatenate(ids + [-np.ones(pad, int)]))

    sel = np.stack([row() for _ in range(b)]).astype(np.int32)
    valid = (sel >= 0) & (r.random((b, l)) >= 0.1)
    sel[~valid & (r.random((b, l)) < 0.5)] = -1
    return sel, valid, tile_start, ntiles


@pytest.mark.parametrize("b,l,nl,mnt", [
    (3, 50, 40, 1), (300, 8, 2000, 2), (10_000, 100, 2000, 2),
    (10_000, 8, 2000, 2), (4_096, 40, 20_000, 16),
    (2_048, 20, 70_000, 2)])   # three sort passes from 65,536 leaves
def test_plan_kernel_bit_equal_to_invert(cuda, b, l, nl, mnt):
    sel, valid, tile_start, ntiles = _plan_operands(b + l, b, l, nl, mnt)
    if b > 4 * ps.QG:
        counts = np.bincount(sel[valid], minlength=nl)
        assert counts.max() > 4 * ps.QG and (counts == 0).any()
    g_pad, w_pad = ps.plan_capacities(b, l, nl, int(ntiles.sum()), mnt)
    args = [torch.as_tensor(a) for a in (sel, valid, tile_start, ntiles)]
    want = ps.invert(*args, mnt, g_pad, w_pad)
    before = ps.launches_plan
    got = ps.work_plan(*(a.to(cuda) for a in args), mnt, g_pad)
    torch.cuda.synchronize()
    assert ps.launches_plan == before + 1
    for name, g, w in zip(ps.WorkPlan._fields, got, want):
        assert g.is_cuda and g.dtype == w.dtype, name
        assert torch.equal(g.cpu(), w), name


def _searcher(engine):
    r = np.random.default_rng(0)
    db = r.standard_normal((20000, 48)).astype(np.float32)
    q = r.standard_normal((256, 48)).astype(np.float32)
    b = scann_torch.builder(db, 10, "dot_product").tree(
        num_leaves=32, num_leaves_to_search=4, training_sample_size=10000)
    if engine == "tree_ah":
        b = b.score_ah(2, anisotropic_quantization_threshold=0.2,
                       training_sample_size=10000)
    else:
        b = b.score_brute_force(quantize="int8")
    return b.build(), q


@pytest.mark.parametrize("engine", ["tree_ah", "tree_sq"])
def test_pruned_select_never_waits_on_the_host(cuda, engine):
    s, q = _searcher(engine)
    s.search_batched(q, leaves_to_search=4)   # the lazy layout, the builds
    scorer, counter = ((pruned_lut, "launches_lut") if engine == "tree_ah"
                       else (pruned_sq, "launches"))
    qd = torch.as_tensor(q, device=cuda)
    torch.cuda.synchronize()
    before = (ps.launches_plan, getattr(scorer, counter))
    torch.cuda.set_sync_debug_mode("error")
    try:
        vals, ids = s._pruned_select(qd, 20, 4, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (ps.launches_plan, getattr(scorer, counter)) == \
        (before[0] + 1, before[1] + 1)
    assert vals.shape == ids.shape == (256, 20)
    # 16 queries x 4 leaves <= QG: invert_small's plan, no plan kernel.
    s.search_batched(q[:16], leaves_to_search=4)
    assert ps.launches_plan == before[0] + 1
    s.search_batched(q, leaves_to_search=4)
    assert ps.launches_plan == before[0] + 2
