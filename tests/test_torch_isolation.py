"""The port stands alone: scann_torch and chip_smoke.py import neither JAX
nor the JAX package, entry points default to CUDA and raise without it,
configurations the port does not serve raise NotImplementedError, and
chip_smoke.py's copy of the benchmark corpus is bench.py's."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import scann_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        scann_torch.__path__, "scann_torch."))


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert "scann_torch.ops.pruned_sq" in mods and len(mods) >= 15
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


_UNPORTED = {
    "soar": lambda b: _tree(b, soar_lambda=1.5).score_brute_force("int8"),
    "avq": lambda b: _tree(b, avq=2.0).score_brute_force("int8"),
    "spilling": lambda b: _tree(
        b, query_spilling_type="additive").score_brute_force("int8"),
    "int8_centroids": lambda b: _tree(
        b, quantize_centroids=True).score_brute_force("int8"),
    "hierarchical": lambda b: _tree(
        b, hierarchical_top=2).score_brute_force("int8"),
    "float32_leaves": lambda b: _tree(b).score_brute_force(),
    "int8_brute_force": lambda b: b.score_brute_force("int8"),
    "score_ah": lambda b: b.score_ah(2),
    "reorder": lambda b: b.reorder(10),
    "pca": lambda b: b.pca(2),
    "autopilot": lambda b: b.autopilot(),
    "upper_tree": lambda b: b.upper_tree(2, 1),
}


@pytest.mark.parametrize("name", sorted(_UNPORTED))
def test_unported_settings_raise(name):
    db = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        _UNPORTED[name](scann_torch.builder(db, 3, "dot_product",
                                            device="cpu")).build()


def test_unported_measures_and_search_params_raise():
    db = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    for measure in ("cosine", "l1"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
            scann_torch.builder(db, 3, measure,
                                device="cpu").score_brute_force().build()
    s = scann_torch.builder(db, 3, "dot_product",
                            device="cpu").score_brute_force().build()
    for kw in ({"pre_tokenized_leaves": np.zeros((2, 1), np.int32)},
               {"post_reordering_epsilon": 0.5},
               {"final_num_neighbors": np.array([1, 2])}):
        with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
            s.search_batched(db[:2], **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        scann_torch.builder(db, 3, "dot_product",
                            device="cpu").score_brute_force().build(
                                docids=list(range(64)))
