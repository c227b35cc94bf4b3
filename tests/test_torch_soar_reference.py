"""The port's SOAR (spilled assignment, the two-slot layout, the dedup)
against the plain reference portbench/reference/soar.py, which imports
neither JAX nor scann_torch, on a glove-100-shaped corpus at a small size
on the CPU: 6,000 x 100 unit rows in topics of a dozen
(portbench/corpora/glove_like.py), 40 leaves.

* The port's ``tokenize_database_soar`` against ``assign``: primaries
  equal but at float32 ties of the squared distance, secondaries equal on
  >= 99.9% of rows, each disagreement a near-tie of the SOAR loss (1e-5
  relative).
* A SOAR searcher that keeps every candidate (pre-reorder budget above
  the searched rows, all 32 slots of a group kept, every searched leaf
  merged whole) on the pruned plan and on ``invert_small``: its top 10
  equals the leaf-restricted exact top 10 on >= 99.9% of entries, each
  distance within 1e-6 of the float64 one in units of |q||x| (TF32 or bf16
  products miss this by orders), no id outside the searched leaves, no id
  twice.  With the secondary slots dropped from its layout the same
  comparison fails on coverage.
* The ``dedup`` span and stage mark under SOAR, on the pruned and the
  dense path, and never without SOAR; the ``spill`` phase and the
  ``secondary_slots`` count in the build."""

import ast

import numpy as np
import pytest
import torch

import scann_torch
from portbench.corpora import glove_like
from portbench.reference import soar as ref
from scann_torch.models import tree_ah
from scann_torch.partitioning import kmeans_tree
from scann_torch.utils import profiling
import torch_threads  # noqa: F401  (torch threads per xdist worker)

LAMBDA = 1.5
LEAVES = 6          # searched leaves: under pruned_scan.HOT_LEAVES, so the
# merge takes every searched leaf at full survivor width
KEEP_ALL = 4000     # pre-reorder budget above any query's searched rows
NOT_SOAR_MARKS = ["tokenize", "plan", "score", "merge", "reorder", "finish"]


def _glove_like(n, nq, seed=17):
    """Rows and queries of the benchmark's glove-100-shaped corpus."""
    rows, q = glove_like.make({"rows": n, "dims": 100, "rows_per_topic": 12,
                               "noise": 0.045}, seed, nq, "cpu")
    return rows.numpy(), q.numpy()


def _builder(db, soar=True):
    return (scann_torch.builder(db, 10, "dot_product", device="cpu")
            .set_seed(5)
            .tree(num_leaves=40, num_leaves_to_search=LEAVES,
                  training_sample_size=len(db),
                  soar_lambda=LAMBDA if soar else None,
                  overretrieve_factor=2.0 if soar else None)
            .score_ah(2, anisotropic_quantization_threshold=0.2)
            .reorder(150))


@pytest.fixture(scope="module")
def data():
    return _glove_like(6000, 400)


@pytest.fixture(scope="module")
def built(data):
    """(searcher, span totals of its build, secondary slots it counted)."""
    db, _ = data
    was = profiling.enable_spans(True)
    try:
        profiling.reset_span_totals()
        before = tree_ah.secondary_slots
        s = _builder(db).build()
        counted = tree_ah.secondary_slots - before
        totals = profiling.span_totals()
    finally:
        profiling.enable_spans(was)
        profiling.reset_span_totals()
    s._kpg_override = 32    # every slot of a 32-slot group survives
    return s, totals, counted


def _reference_answer(s, data, leaves):
    db, q = data
    rows, centers = torch.as_tensor(db), s.partitioner.centers
    assignment = ref.assign(rows, centers, LAMBDA)
    return assignment, ref.search(rows, torch.as_tensor(q), centers,
                                  assignment, leaves, 10)


def _held_to_reference(s, data, queries, leaves):
    """(share of top-10 entries equal to the leaf-restricted exact answer,
    its recall, widest distance gap over |q||x|, ids outside the searched
    leaves, rows with an id twice)."""
    db, _ = data
    rows = torch.as_tensor(db)
    q = torch.as_tensor(queries)
    assignment, (want, _) = _reference_answer(s, (db, queries), leaves)
    idx, dist = s.search_batched(queries, leaves_to_search=leaves,
                                 pre_reorder_num_neighbors=KEEP_ALL)
    idx = torch.as_tensor(idx).long()
    d64 = (rows.double()[idx] * q.double()[:, None, :]).sum(-1)
    scale = torch.linalg.norm(q.double(), dim=1)[:, None] \
        * torch.linalg.norm(rows.double()[idx], dim=-1)
    gap = float(((torch.as_tensor(dist).double() - d64).abs()
                 / scale).max())
    return (float((idx == want).double().mean()), ref.recall(idx, want),
            gap, ref.outside_searched(idx, q, s.partitioner.centers,
                                      assignment, leaves),
            ref.repeated(idx))


def test_reference_stands_alone():
    """The reference imports torch alone."""
    with open(ref.__file__, "rb") as f:
        body = f.read()
    imported = set()
    for node in ast.walk(ast.parse(body)):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert imported == {"__future__", "contextlib", "torch"}


@pytest.mark.parametrize("case", ["glove_index", "random"])
def test_tokenize_database_soar_against_assign(case, built, data):
    """glove_index: the built index's centers and rows; random: Gaussian
    rows and centers, where near-ties of the loss are common."""
    if case == "glove_index":
        s = built[0]
        rows = torch.as_tensor(data[0])
        centers = s.partitioner.centers
        got = s.partitioner.tokenize_database_soar(rows, s.part_cfg.soar)
    else:
        r = np.random.default_rng(3)
        rows = torch.as_tensor(r.standard_normal((6000, 32)),
                               dtype=torch.float32)
        centers = torch.as_tensor(r.standard_normal((64, 32)),
                                  dtype=torch.float32)
        got = kmeans_tree.KMeansTreePartitioner(
            centers=centers, query_distance="dot_product"
        ).tokenize_database_soar(rows, scann_torch.config.SoarConfig(LAMBDA))
    c = ref.compare_assignment(rows, centers, LAMBDA, got)
    assert c["rows"] == len(rows) and c["secondary_is_primary"] == 0
    assert c["primary_not_tied"] == 0 and c["secondary_not_near_tie"] == 0
    assert c["primary_differ"] <= 0.001 * len(rows)
    assert c["secondary_differ"] <= 0.001 * c["secondary_compared"]


def test_layout_holds_each_row_twice(built, data):
    s, _, counted = built
    n = len(data[0])
    assert counted == n and s._num_slots == 2 * n
    assignment = ref.assign(torch.as_tensor(data[0]), s.partitioner.centers,
                            LAMBDA)
    # No leaf here is large enough for the build's caps to move a row.
    np.testing.assert_array_equal(np.asarray(s.datapoint_to_token),
                                  assignment.numpy())


@pytest.mark.parametrize("plan", ["work_plan", "invert_small"])
def test_search_is_the_leaf_restricted_exact_answer(plan, built, data):
    """work_plan: 400 queries x 6 leaves; invert_small: 16 x 4 (at most
    pruned_scan.QG pairs)."""
    s = built[0]
    q, leaves = (data[1], LEAVES) if plan == "work_plan" \
        else (data[1][:16], 4)
    equal, rec, gap, outside, twice = _held_to_reference(s, data, q, leaves)
    assert equal >= 0.999 and rec >= 0.999
    assert gap <= 1e-6
    assert outside == 0 and twice == 0


def test_dropping_the_secondaries_fails_coverage(built, data):
    """The same comparison on the same index with every secondary slot
    freed: the rows reachable through their secondary leaf alone go
    missing."""
    s = built[0]
    db, q = data
    _, (want, _) = _reference_answer(s, data, LEAVES)
    kept = s._host["dpid"].copy()
    h = s._host
    live = h["dpid"] >= 0
    secondary = live & (h["leaf"] == np.asarray(s.datapoint_to_token)[
        np.maximum(h["dpid"], 0), 1])
    assert secondary.sum() == len(db)
    try:
        h["dpid"][secondary] = -1
        s._invalidate_pruned()
        idx, _ = s.search_batched(q, leaves_to_search=LEAVES,
                                  pre_reorder_num_neighbors=KEEP_ALL)
    finally:
        h["dpid"][:] = kept
        s._invalidate_pruned()
    assert ref.recall(idx, want) < 0.99


def _marks_and_spans(s, q, **kw):
    """(stage marks of one search, span names)."""
    marks = []
    s.stage_hook = marks.append
    was = profiling.enable_spans(True)
    try:
        profiling.reset_span_totals()
        s.search_batched(q, **kw)
        names = set(profiling.span_totals())
    finally:
        profiling.enable_spans(was)
        profiling.reset_span_totals()
        s.stage_hook = None
    return marks, names


@pytest.mark.parametrize("path", ["pruned", "dense"])
def test_dedup_stage_span_and_counters_under_soar(path, built, data):
    s, totals, _ = built
    q = data[1][:50]
    kw = {"pruned": {}, "dense": dict(leaves_to_search=40)}[path]
    marks, names = _marks_and_spans(s, q, **kw)
    first = {"pruned": ["tokenize", "plan", "score", "merge"],
             "dense": ["tokenize", "scan"]}[path]
    assert marks == first + ["dedup", "reorder", "finish"]
    assert "dedup" in names
    assert s._k_fetch(150) == 300                 # 150 x 2.0 enter it
    assert {"spill", "partition"} <= set(totals)
    assert totals["spill"][0] <= totals["partition"][0]


def test_no_dedup_without_soar(data):
    """A glove-shaped searcher without SOAR: the parent's stage marks, no
    dedup span, no count, no spill phase."""
    db, q = data[0][:2000], data[1][:50]
    was = profiling.enable_spans(True)
    try:
        profiling.reset_span_totals()
        slots = tree_ah.secondary_slots
        s = _builder(db, soar=False).build()
        built_names = set(profiling.span_totals())
    finally:
        profiling.enable_spans(was)
        profiling.reset_span_totals()
    assert tree_ah.secondary_slots == slots and "spill" not in built_names
    marks, names = _marks_and_spans(s, q)
    assert marks == NOT_SOAR_MARKS
    assert "dedup" not in names
