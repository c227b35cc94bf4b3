"""The port stands alone: scann_torch and chip_smoke.py import neither JAX
nor the JAX package, entry points default to CUDA and raise without it,
every setting is served (no refusal remains; the former refusal cases,
autopilot among them, build and search), and chip_smoke.py's copy of the
benchmark corpus is bench.py's."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import scann_torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        scann_torch.__path__, "scann_torch."))


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert "scann_torch.ops.pruned_sq" in mods and len(mods) >= 15
    assert {"scann_torch.data.dataset", "scann_torch.data.sparse",
            "scann_torch.ops.projection", "scann_torch.ops.stacked"} <= \
        set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'scann_tpu')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_and_port_sources_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "scann_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        roots = _imported_roots(path)
        assert not roots & {"jax", "jaxlib", "scann_tpu", "bench"}, path


def test_parallel_package_imports_no_jax():
    """The sharded index (scann_torch/parallel/) and the job the CPU tests
    spawn for it import neither JAX nor the JAX package, and every module
    the JAX package's parallel/ has stands there."""
    mods = set(_port_modules())
    assert {"scann_torch.parallel.mesh", "scann_torch.parallel.build",
            "scann_torch.parallel.layout", "scann_torch.parallel.launch",
            "scann_torch.parallel.dryrun"} <= mods
    jax_side = {f[:-3] for f in os.listdir(os.path.join(
        ROOT, "scann_tpu", "parallel")) if f.endswith(".py")}
    port_side = {f[:-3] for f in os.listdir(os.path.join(
        ROOT, "scann_torch", "parallel")) if f.endswith(".py")}
    assert jax_side <= port_side
    files = [os.path.join(ROOT, "tests", "torch_sharded_job.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "scann_torch",
                                                  "parallel")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) >= 6
    for path in files:
        roots = _imported_roots(path)
        assert not roots & {"jax", "jaxlib", "scann_tpu", "bench"}, path


def test_chip_smoke_corpus_matches_bench():
    import bench
    import chip_smoke
    assert chip_smoke.TOPICS_PER_ROW == bench.TOPICS_PER_ROW
    assert chip_smoke.TOPIC_NOISE == bench.TOPIC_NOISE
    for args in ((3000, 40, 100), (700, 5, 24, 3)):
        a = chip_smoke.make_glove_like(*args)
        b = bench.make_glove_like(*args)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_chip_smoke_sift_corpus_matches_extra_configs():
    """chip_smoke.make_sift_like (the tree-SQ + reorder phase's corpus, and
    at 960 dimensions the wide phase's) is a copy of
    benchmarks/extra_configs.make_sift_like."""
    import importlib.util
    import chip_smoke
    spec = importlib.util.spec_from_file_location(
        "extra_configs", os.path.join(ROOT, "benchmarks", "extra_configs.py"))
    extra = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(extra)
    for args in ((3000, 40, 128), (500, 5, 96, 9)):
        a = chip_smoke.make_sift_like(*args)
        b = extra.make_sift_like(*args)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_default_device_is_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    db = np.zeros((16, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scann_torch.builder(db, 10, "dot_product")
    s = scann_torch.builder(db, 2, "dot_product",
                            device="cpu").score_brute_force().build()
    s.serialize(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scann_torch.load_searcher(str(tmp_path))


def _tree(b, **kw):
    return b.tree(num_leaves=4, num_leaves_to_search=2, **kw)


_AUTOPILOT = {
    # The former refusal cases: each setting beside autopilot, which the
    # factory rewrites (ROADMAP item 17) into the JAX package's config.
    "int8_brute_force": lambda b: b.score_brute_force("int8").autopilot(),
    "score_ah": lambda b: _tree(b).score_ah(2).reorder(
        10, quantize="int8").opq().autopilot(),
    "reorder": lambda b: b.score_brute_force().reorder(10).autopilot(),
    "pca": lambda b: _tree(b).pca(
        2, pca_significance_threshold=None).score_brute_force(
            "int8").autopilot(),
    "autopilot": lambda b: b.autopilot(),
}


@pytest.mark.parametrize("name", sorted(_AUTOPILOT))
def test_autopilot_settings_build_and_search(name):
    import scann_tpu
    from scann_tpu.utils import autopilot as jap
    db = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    s = _AUTOPILOT[name](scann_torch.builder(db, 3, "dot_product",
                                             device="cpu")).build()
    want = jap.autopilot_rewrite(_AUTOPILOT[name](scann_tpu.builder(
        db, 3, "dot_product")).create_config(), db)
    assert s.config.to_json() == want.to_json()
    # A 64-row corpus rewrites to brute force: exact dot products.
    idx, dist = s.search_batched(db[:4])
    assert idx.shape == (4, 3)
    np.testing.assert_array_equal(idx[:, 0], (db[:4] @ db.T).argmax(1))
    assert np.isfinite(dist).all()


def test_no_refusal_remains():
    """No setting refuses: the refusal helper and its calls are gone."""
    from scann_torch.models import base
    assert not hasattr(base, "not_ported")
    for dirpath, _, names in os.walk(os.path.join(ROOT, "scann_torch")):
        for n in names:
            if n.endswith(".py"):
                text = open(os.path.join(dirpath, n)).read()
                assert "not_ported(" not in text, n
                assert "is not ported yet" not in text, n


_FORMERLY_UNPORTED = {
    "float32_leaves": lambda b: _tree(b).score_brute_force(),
    "int8_brute_force": lambda b: b.score_brute_force("int8"),
    "score_ah": lambda b: b.score_ah(2).reorder(10, quantize="int8"),
    "reorder": lambda b: b.score_brute_force().reorder(10),
    # ROADMAP item 14's partitioning settings.  Tree-X reads neither SOAR
    # nor AVQ (as in the JAX package): it builds the index it builds
    # without them.
    "soar": lambda b: _tree(b, soar_lambda=1.5).score_brute_force("int8"),
    "avq": lambda b: _tree(b, avq=2.0).score_brute_force("int8"),
    "spilling": lambda b: _tree(
        b, query_spilling_type="additive").score_brute_force("int8"),
    "int8_centroids": lambda b: _tree(
        b, quantize_centroids=True).score_brute_force("int8"),
    "hierarchical": lambda b: _tree(
        b, hierarchical_top=2).score_brute_force("int8"),
    "soar_float32_leaves": lambda b: _tree(
        b, soar_lambda=1.5).score_brute_force(),
    "upper_tree": lambda b: _tree(b).upper_tree(2, 1).score_brute_force(
        "int8"),
    # ROADMAP items 13 and 16: projections, stacked and variable-chunk
    # codes, the single-leaf AH tree.
    "pca": lambda b: _tree(b).pca(
        4, pca_significance_threshold=None).score_brute_force("int8"),
    "opq": lambda b: b.score_ah(2).reorder(10, quantize="int8").opq(),
    "truncate": lambda b: b.truncate(6).score_brute_force().reorder(5),
    "stacked": lambda b: _tree(b).score_ah(
        2, quantization_scheme="stacked").reorder(5),
    "variable_chunks": lambda b: _tree(b).score_ah(
        2, variable_dims_per_block=[4, 2, 2]).reorder(5),
    "single_leaf_tree": lambda b: b.tree(1, 1).score_ah(2).reorder(5),
}


@pytest.mark.parametrize("name", sorted(_FORMERLY_UNPORTED))
def test_formerly_unported_settings_build_and_search(name):
    db = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    s = _FORMERLY_UNPORTED[name](scann_torch.builder(
        db, 3, "dot_product", device="cpu")).build()
    idx, dist = s.search_batched(db[:4])
    assert idx.shape == (4, 3) and (idx >= 0).all()
    assert np.isfinite(dist).all()


def test_unported_measures_and_search_params_raise():
    db = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    # Cosine and L1 are served (brute force; cosine with any scorer).
    for measure in ("cosine", "l1"):
        s = scann_torch.builder(db, 3, measure,
                                device="cpu").score_brute_force().build()
        idx, _ = s.search_batched(db[:2])
        assert (idx[:, 0] == [0, 1]).all()
    # The item-14 search parameters are served: pre-tokenized leaves on a
    # tree, the post-reordering epsilon and a per-query k.
    s = _tree(scann_torch.builder(db, 3, "dot_product", device="cpu")
              ).score_brute_force("int8").build()
    idx, dist = s.search_batched(
        db[:2], pre_tokenized_leaves=np.array([[0, -1], [1, 0]], np.int32))
    assert idx.shape == (2, 3) and (idx[:, 0] >= 0).all()
    idx, dist = s.search_batched(db[:2], post_reordering_epsilon=1e9)
    assert (idx == -1).all() and np.isnan(dist).all()
    idx, _ = s.search_batched(db[:2], final_num_neighbors=np.array([1, 2]))
    assert (idx[0, 1:] == -1).all() and (idx[1, :2] >= 0).all()
    # Docids are served (ROADMAP item 15): results are docids, and the
    # searcher takes upserts.
    s = scann_torch.builder(db, 3, "squared_l2",
                            device="cpu").score_brute_force().build(
                                docids=[f"d{i}" for i in range(64)])
    idx, _ = s.search_batched(db[:2])
    assert [row[0] for row in idx] == ["d0", "d1"]
    s.upsert(["d64"], -db[:1])
    assert s.search(-db[0])[0][0] == "d64"


def test_typed_and_sparse_inputs_build_and_search():
    """Typed int8 / uint8 datasets, a DenseDataset without docids and
    sparse input are served (ROADMAP items 11 and 16)."""
    from scann_torch.data import dataset
    r = np.random.default_rng(0)
    for dtype in (np.int8, np.uint8):
        db = r.integers(0, 100, (64, 8)).astype(dtype)
        for make in (lambda b: b.score_brute_force(),
                     lambda b: _tree(b).score_brute_force("int8")):
            s = make(scann_torch.builder(dataset.DenseDataset(db), 3,
                                         "squared_l2", device="cpu")).build()
            idx, _ = s.search_batched(db[:4].astype(np.float32))
            assert (idx[:, 0] == np.arange(4)).all()
    m = scann_torch.SparseMatrix.from_any(r.standard_normal((64, 40)) *
                                          (r.random((64, 40)) < 0.2))
    s = scann_torch.sparse_searcher(m, 3, device="cpu")
    idx, _ = s.search_batched(m)
    assert idx.shape == (64, 3)
    idx, _ = scann_torch.SparseExactSearcher(m, 3, device="cpu"
                                             ).search_batched(m)
    assert idx.shape == (64, 3)


@pytest.mark.parametrize("item", [13, 15, 16, 17, 19])
def test_no_refusal_names_a_served_item(item):
    """Items 13, 15, 16, 17 and 19 are served: no refusal names them."""
    import re
    call = re.compile(r"not_ported\([^()]*,\s*(\d+)\)")
    for dirpath, _, names in os.walk(os.path.join(ROOT, "scann_torch")):
        for n in names:
            if n.endswith(".py"):
                text = open(os.path.join(dirpath, n)).read()
                assert str(item) not in call.findall(text), n
                assert f"ROADMAP item {item}" not in text, n


def test_no_refusal_names_item_14():
    for dirpath, _, names in os.walk(os.path.join(ROOT, "scann_torch")):
        for n in names:
            if n.endswith(".py"):
                text = open(os.path.join(dirpath, n)).read()
                assert "not_ported(" not in text or ", 14)" not in text, n
                assert "item 14" not in text, n
