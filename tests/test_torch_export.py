"""Export (ROADMAP item 18) and the kernels' custom ops, on the CPU.

Four JAX-built indexes (tree-SQ, tree-AH int8 lookup + reorder,
reconstruct mode, brute force) are loaded by the port, exported with
``save_exported_searcher`` and reloaded in a fresh process that imports
only ``scann_torch.export``: the reloaded programs' ids equal the live
port searcher's, and on >= 99.9% of entries the JAX package's CPU export
of the same index (reconstruct mode: the JAX searcher itself, since the
JAX package's export of it cannot be reloaded -- its state.npz stores
the bfloat16 rows as raw void bytes, a reference fault pinned below).
Also the operating point, batches larger than the
bucket, ``meta.json``, and ``torch.library.opcheck`` of every op of
ops/library.py with its CPU (plain) implementation, whose results equal
the plain versions'."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import scann_torch
import scann_tpu
from scann_torch import export as texport
from scann_torch.ops import fused_scan, library, pruned_lut
from scann_torch.ops import pruned_scan as ps
from scann_torch.ops import pruned_sq
from scann_torch.tools import op_cases
import torch_threads  # noqa: F401  (torch threads per xdist worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKET = 64


def make_data(n=6000, d=32, nq=100, seed=3):
    """Unit rows and queries around many loose topics (the tree-AH parity
    tests' corpus shape)."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((300, d))
    db = c[rng.integers(0, 300, n)] + 0.5 * rng.standard_normal((n, d))
    q = c[rng.integers(0, 300, nq)] + 0.5 * rng.standard_normal((nq, d))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return db.astype(np.float32), q.astype(np.float32)


def _jax_searchers(db, root):
    """JAX-built indexes, serialized under ``root``/<name>/native.  The
    reconstruct-mode index is the tree-AH index's files with their
    lookup type changed (both loaders decode the rows from the codes)."""
    tree = dict(num_leaves=32, num_leaves_to_search=6,
                training_sample_size=4000)
    out = {
        "tree_sq": scann_tpu.builder(db, 10, "dot_product").tree(**tree)
        .score_brute_force(quantize="int8").build(),
        "tree_ah": scann_tpu.builder(db, 10, "dot_product").tree(**tree)
        .score_ah(2, anisotropic_quantization_threshold=0.2).reorder(30)
        .build(),
        "brute_force": scann_tpu.builder(db, 10, "squared_l2")
        .score_brute_force().build(),
    }
    for name, js in out.items():
        js.serialize(str(root / name / "native"))
    recon = root / "reconstruct" / "native"
    shutil.copytree(root / "tree_ah" / "native", recon)
    cfg_path = recon / "scann_config.json"
    blob = json.loads(cfg_path.read_text())
    blob["config"]["asymmetric_hash"]["lookup_type"] = "reconstruct"
    cfg_path.write_text(json.dumps(blob))
    out["reconstruct"] = scann_tpu.load_searcher(str(recon))
    return out


_RELOAD = """
import json, sys
import numpy as np
from scann_torch import export
out = {}
for name, path in json.loads(sys.argv[1]).items():
    ex = export.load_exported_searcher(path)
    q = np.load(sys.argv[2])
    out[name + "_idx"], out[name + "_dist"] = ex.search_batched(q)
assert not [m for m in sys.modules if m == "jax" or m.startswith(
    ("jax.", "scann_tpu"))]
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    db, q = make_data()
    root = tmp_path_factory.mktemp("exports")
    from scann_tpu import export as jexport
    live, jax_out, paths, port = {}, {}, {}, {}
    for name, js in _jax_searchers(db, root).items():
        native = str(root / name / "native")
        ts = port[name] = scann_torch.load_searcher(native, device="cpu")
        paths[name] = str(root / name / "torch")
        assert texport.save_exported_searcher(
            paths[name], ts, batch_sizes=(BUCKET,)) == [BUCKET]
        live[name] = ts.search_batched(q)
        jpath = str(root / name / "jax")
        jexport.save_exported_searcher(jpath, js, batch_sizes=(BUCKET,))
        if name == "reconstruct":
            with pytest.raises(TypeError, match="not a valid JAX array"):
                jexport.load_exported_searcher(jpath).search_batched(q)
            jax_out[name] = js.search_batched(q)
        else:
            jax_out[name] = jexport.load_exported_searcher(
                jpath).search_batched(q)
    np.save(root / "q.npy", q)
    res = root / "reloaded.npz"
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _RELOAD, json.dumps(paths),
         str(root / "q.npy"), str(res)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with np.load(res) as z:
        reloaded = {k: z[k] for k in z.files}
    return q, live, jax_out, paths, reloaded, port


@pytest.mark.parametrize("name", ["tree_sq", "tree_ah", "reconstruct",
                                  "brute_force"])
def test_reloaded_export_equals_live_and_jax_export(exported, name):
    q, live, jax_out, paths, reloaded, _ = exported
    idx, dist = reloaded[name + "_idx"], reloaded[name + "_dist"]
    # 100 queries through a 64-query bucket: one full chunk, one padded.
    assert idx.shape == (len(q), 10)
    np.testing.assert_array_equal(idx, live[name][0])
    np.testing.assert_array_equal(dist, live[name][1])
    jidx, jdist = (np.asarray(a) for a in jax_out[name])
    # Each JAX id held by membership in the port's row (a candidate one
    # package finds and the other does not shifts the later positions),
    # its distance against that entry's.
    match = jidx[:, :, None] == idx[:, None, :]
    assert match.any(-1).mean() >= 0.999
    found = match.any(-1)
    got = np.take_along_axis(dist, match.argmax(-1), axis=1)[found]
    np.testing.assert_allclose(got, jdist[found], rtol=1e-4, atol=1e-4)
    meta = json.load(open(os.path.join(paths[name], "meta.json")))
    assert meta["buckets"] == [BUCKET] and meta["platforms"] == ["cpu"]
    assert meta["dims"] == 32 and meta["k"] == 10
    assert meta["fused_merge"] is False
    assert set(meta) == {"buckets", "k", "k_pre", "leaves", "dims",
                         "distance_measure", "platforms", "fused_merge"}


def test_export_holds_the_kernel_ops(exported):
    _, _, _, paths, _, _ = exported
    want = {"tree_sq": {"pruned_plan", "pruned_sq_score", "pruned_merge"},
            "tree_ah": {"pruned_plan", "pruned_lut_build",
                        "pruned_lut_score", "pruned_merge"},
            "reconstruct": {"pruned_plan", "pruned_rows_score",
                            "pruned_merge"},
            "brute_force": set()}
    for name, ops in want.items():
        ep = torch.export.load(os.path.join(paths[name],
                                            f"search_b{BUCKET}.pt2"))
        got = {str(n.target).split(".")[1] for n in ep.graph.nodes
               if str(n.target).startswith("scann_torch.")}
        assert got == ops, (name, got)


@pytest.mark.parametrize("fused", [False, True])
def test_export_operating_point_and_large_batches(exported, tmp_path,
                                                  monkeypatch, fused):
    q, s = exported[0], exported[5]["tree_ah"]
    if fused:
        monkeypatch.setenv("SCANN_TORCH_FUSED_MERGE", "1")
    kw = dict(leaves_to_search=10, pre_reorder_num_neighbors=30,
              final_num_neighbors=5)
    live = s.search_batched(q, **kw)
    # Two buckets without the fused merge (bucket choice), one with it.
    sizes = (33,) if fused else (20, 33)
    buckets = texport.save_exported_searcher(str(tmp_path), s,
                                             batch_sizes=sizes, **kw)
    assert buckets == ([64] if fused else [32, 64])
    ex = scann_torch.load_exported_searcher(str(tmp_path))
    assert ex.meta["fused_merge"] is fused
    assert (ex.meta["k"], ex.meta["k_pre"], ex.meta["leaves"]) == (5, 30, 10)
    idx, dist = ex.search_batched(q)          # 100 > 64: chunks
    np.testing.assert_array_equal(idx, live[0])
    np.testing.assert_array_equal(dist, live[1])
    idx, _ = ex.search_batched(q[:7])         # the smallest bucket, padded
    np.testing.assert_array_equal(idx, live[0][:7])
    # Exporting leaves no stage hook or layout behind that changes search.
    np.testing.assert_array_equal(s.search_batched(q, **kw)[0], live[0])


# ------------------------------------------------------------- the ops
@pytest.mark.parametrize("name", [op._name
                                  for op in library.OPS])
def test_op_opcheck_and_plain_equal(name):
    op, args, plain = op_cases.op_cases()[name]
    torch.library.opcheck(op, args)
    got, want = op(*args), plain()
    if isinstance(want, tuple):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert torch.equal(got, want)
    assert getattr(torch.ops.scann_torch, name).default is not None


def test_cpu_calls_count_no_launch_and_other_devices_refuse():
    before = (pruned_sq.launches, ps.launches, pruned_lut.launches_lut,
              pruned_lut.launches_codes, fused_scan.launches,
              ps.launches_merge, ps.launches_plan, ps.launches_select)
    for op, args, _ in op_cases.op_cases().values():
        op(*args)
    assert before == (pruned_sq.launches, ps.launches,
                      pruned_lut.launches_lut, pruned_lut.launches_codes,
                      fused_scan.launches, ps.launches_merge,
                      ps.launches_plan, ps.launches_select)
    rows = torch.zeros((1, 2048, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_scan.fused_scan_groupmax(
            torch.zeros((1, 64), dtype=torch.bfloat16, device="meta"),
            rows[0], torch.zeros(2048, device="meta"))
