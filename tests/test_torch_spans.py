"""The port's host spans (scann_torch/utils/profiling.py) on the CPU: the
search span and its stage spans against the stage marks, the result span's
batch id, a split search's nesting, the build and first-use totals, the
off path, log_phase, and a torch.export program with spans on."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import scann_torch
from scann_torch.models import base
from scann_torch.utils import profiling
import torch_threads  # noqa: F401  (torch threads per xdist worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("tokenize", "plan", "score", "merge", "scan", "reorder", "finish")
P = profiling.PREFIX


def _data(n=2000, nq=60, d=16, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((24, d))
    db = c[rng.integers(0, 24, n)] + 0.3 * rng.standard_normal((n, d))
    q = c[rng.integers(0, 24, nq)] + 0.3 * rng.standard_normal((nq, d))
    return db.astype(np.float32), q.astype(np.float32)


def _builder(kind, db):
    b = scann_torch.builder(db, 10, "squared_l2" if kind == "tree_x"
                            else "dot_product", device="cpu")
    if kind == "brute_force":
        return b.score_brute_force()
    b = b.tree(num_leaves=16, num_leaves_to_search=4,
               training_sample_size=len(db))
    if kind == "tree_ah":
        return b.score_ah(2, anisotropic_quantization_threshold=0.2) \
            .reorder(30)
    return b.score_brute_force(quantize="int8").reorder(30)


# kind -> (stage marks of one search, the build's spans)
KINDS = {
    "tree_ah": (["tokenize", "plan", "score", "merge", "reorder", "finish"],
                {"build", "partition", "quantize", "layout"}),
    "tree_x": (["tokenize", "plan", "score", "merge", "reorder", "finish"],
               {"build", "partition", "quantize", "layout"}),
    "brute_force": (["scan", "finish"], {"build", "layout", "quantize"}),
}


@pytest.fixture(scope="module")
def built():
    """kind -> (searcher, the span totals of its build)."""
    db, _ = _data()
    was = profiling.enable_spans(True)
    out = {}
    try:
        for kind in KINDS:
            profiling.reset_span_totals()
            out[kind] = (_builder(kind, db).build(), profiling.span_totals())
    finally:
        profiling.enable_spans(was)
        profiling.reset_span_totals()
    return out


@pytest.fixture
def spans_on():
    was = profiling.enable_spans(True)
    yield
    profiling.enable_spans(was)
    profiling.reset_span_totals()


def _mark(name):
    with torch.profiler.record_function(f"stage.{name}"):
        pass


def _traced(searcher, queries, tmp_path):
    """Host annotations (name, start, end) of one search and its result,
    in start order, with the stage marks as the harness leaves them."""
    searcher.stage_hook = _mark
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = searcher.search_batched(queries)
    finally:
        searcher.stage_hook = None
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    ours = [e for e in ev if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")]
    ann = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in ours
                 if e["name"].startswith((P, "stage."))
                 or e.get("cat") == "user_annotation")
    ops = sorted(float(e["ts"]) for e in ours if e.get("cat") == "cpu_op"
                 and not e["name"].startswith(P))
    return out, [(n, a, b) for a, b, n in ann], ops


def _inside(events, outer):
    _, a, b = outer
    return [e for e in events if a <= e[1] and e[2] <= b and e is not outer]


def _batch_tag(events, outer):
    tags = [n for n, _, _ in _inside(events, outer)
            if n.startswith(profiling.BATCH_TAG)]
    return tags[0]


@pytest.mark.parametrize("kind", list(KINDS))
def test_stage_spans_end_at_their_marks(kind, built, spans_on, tmp_path):
    searcher, _ = built[kind]
    _, q = _data()
    _, ann, ops = _traced(searcher, q, tmp_path)
    search = [e for e in ann if e[0] == P + "search"]
    assert len(search) == 1
    inner = _inside(ann, search[0])
    marks = [e for e in inner if e[0].startswith("stage.")]
    stages = [e for e in inner if e[0] in {P + s for s in STAGES}]
    assert [m[0][len("stage."):] for m in marks] == KINDS[kind][0]
    assert [s[0][len(P):] for s in stages] == KINDS[kind][0]
    for i, (stage, mark) in enumerate(zip(stages, marks)):
        # The mark lies in its stage's span, and no operation starts
        # between the mark and the span's end.
        assert stage[1] <= mark[1] and mark[2] <= stage[2]
        assert not [t for t in ops if mark[2] < t <= stage[2]]
        if i + 1 < len(stages):
            assert stages[i + 1][1] >= mark[2]
    # The result span carries the search's batch id.
    result = [e for e in ann if e[0] == P + "result"]
    assert len(result) == 1 and result[0][1] >= search[0][2]
    assert _batch_tag(ann, result[0]) == _batch_tag(ann, search[0])


def test_split_search_nests_its_sub_batches(built, spans_on, tmp_path,
                                            monkeypatch):
    searcher, _ = built["tree_ah"]
    _, q = _data(nq=100)
    whole = searcher.search_batched(q)
    monkeypatch.setattr(base, "pruned_dispatch_cap", lambda leaves: 40)
    (idx, dist), ann, _ = _traced(searcher, q, tmp_path)
    np.testing.assert_array_equal(idx, whole[0])
    np.testing.assert_allclose(dist, whole[1])
    for name in ("search", "result"):
        spans = [e for e in ann if e[0] == P + name]
        outer = max(spans, key=lambda e: e[2] - e[1])
        subs = _inside(spans, outer)
        assert len(spans) == 4 and len(subs) == 3, name
        if name == "search":
            search_tags = [_batch_tag(ann, s) for s in subs]
            outer_tag = _batch_tag(ann, outer)
        else:
            assert sorted(_batch_tag(ann, s) for s in subs) == \
                sorted(search_tags)
            assert _batch_tag(ann, outer) == outer_tag
    assert len(set(search_tags + [outer_tag])) == 4


@pytest.mark.parametrize("kind", list(KINDS))
def test_build_totals(kind, built):
    _, totals = built[kind]
    assert set(totals) == KINDS[kind][1]
    phases = sum(totals[n][0] for n in totals if n != "build")
    assert 0 < phases <= totals["build"][0]


def test_first_use_registers_and_lays_out(tmp_path):
    """In a fresh process: the first search's lazy pruned layout and the
    custom ops' registration are spans of their own."""
    code = (
        "import json, sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import numpy as np, torch, scann_torch\n"
        "from scann_torch.utils import profiling\n"
        "torch.set_num_threads(2)\n"
        "profiling.enable_spans(True)\n"
        "db = np.random.default_rng(0).standard_normal((800, 8))\n"
        "s = (scann_torch.builder(db.astype(np.float32), 5, 'dot_product',\n"
        "                         device='cpu')\n"
        "     .tree(num_leaves=8, num_leaves_to_search=2)\n"
        "     .score_ah(2).build())\n"
        "built = profiling.span_totals()\n"
        "s.search_batched(db[:20])\n"
        "print(json.dumps([built, profiling.span_totals()]))\n")
    out = subprocess.run([sys.executable, "-c", code, ROOT],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    built, used = json.loads(out.stdout.strip().splitlines()[-1])
    assert "register" not in built and used["register"][1] == 1
    assert used["layout"][1] == built["layout"][1] + 1
    assert used["search"][1] == used["result"][1] == 1


@pytest.mark.parametrize("on", [False, True])
def test_off_path_calls_no_profiler(on, built, tmp_path, monkeypatch):
    """Spans off: no profiler range opened (record_function or the fast
    range) and no scann_torch. range in a trace, no totals, and the stage
    marks as before."""
    searcher, _ = built["tree_ah"]
    _, q = _data()
    was = profiling.enable_spans(on)
    try:
        profiling.reset_span_totals()
        calls = []

        def counting(real):
            def counted(*a, **kw):
                calls.append(a[0])
                return real(*a, **kw)
            return counted

        with monkeypatch.context() as m:
            m.setattr(torch.profiler, "record_function",
                      counting(torch.profiler.record_function))
            m.setattr(torch._C._profiler, "_RecordFunctionFast",
                      counting(torch._C._profiler._RecordFunctionFast))
            searcher.search_batched(q)
        _, ann, _ = _traced(searcher, q, tmp_path)
        totals = profiling.span_totals()
    finally:
        profiling.enable_spans(was)
        profiling.reset_span_totals()
    ours = [n for n, _, _ in ann if n.startswith(P)]
    marks = [n for n, _, _ in ann if n.startswith("stage.")]
    assert marks == ["stage." + s for s in KINDS["tree_ah"][0]]
    if on:
        assert P + "search" in calls and ours and totals["search"][1] == 2
    else:
        assert calls == [] and ours == [] and totals == {}


def test_facility_trace_and_log_phase(tmp_path, caplog):
    """enable_spans returns the state before; trace() turns spans on for
    its block only; log_phase logs its seconds and, spans on, is a span."""
    assert not profiling.spans_enabled()
    with profiling.trace(str(tmp_path)):
        assert profiling.spans_enabled()
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
    assert not profiling.spans_enabled()
    with open(os.path.join(tmp_path, profiling.TRACE_FILE)) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {P + "outer", P + "inner"} <= names
    totals = profiling.span_totals()
    assert totals["outer"][0] >= totals["inner"][0] and \
        totals["inner"][1] == 1
    profiling.reset_span_totals()
    assert profiling.span_totals() == {}
    for on in (False, True):
        was = profiling.enable_spans(on)
        try:
            with caplog.at_level(logging.INFO, logger="scann_torch"):
                with profiling.log_phase("phase x"):
                    pass
            assert "phase x took" in caplog.text
            assert ("phase x" in profiling.span_totals()) == on
        finally:
            assert profiling.enable_spans(was) == on
            profiling.reset_span_totals()
        caplog.clear()


def test_export_holds_no_profiler_op(built, spans_on, tmp_path):
    """save_exported_searcher turns spans off while torch.export traces,
    and back on after."""
    searcher, _ = built["brute_force"]
    _, q = _data(nq=8)
    scann_torch.save_exported_searcher(str(tmp_path), searcher,
                                       batch_sizes=(8,))
    assert profiling.spans_enabled()
    ep = torch.export.load(os.path.join(tmp_path, "search_b8.pt2"))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t]
    idx, _ = scann_torch.load_exported_searcher(
        str(tmp_path)).search_batched(q)
    np.testing.assert_array_equal(idx, searcher.search_batched(q)[0])
