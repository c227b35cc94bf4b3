"""What the benchmark may load: nothing of JAX or the JAX package
anywhere under portbench/, nothing of the program in its reference; and
a run without a card, or without the program, prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import core, spec

BANNED = {"jax", "jaxlib", "flax", "scann_tpu"}


def _sources(sub=""):
    top = os.path.join(spec.PORTBENCH, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    """Top-level names of every module a source imports, compared whole
    (scann_torch begins with scann_t... but is not scann_tpu)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, spec.PORTBENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imported(path)) & BANNED


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "scann_torch" not in set(_imported(path))


def test_banned_names_compare_whole_top_level_names():
    sys.modules.setdefault("scann_torch_lookalike", sys)
    try:
        assert core.banned_modules() == sorted(
            {m.split(".")[0] for m in sys.modules} & BANNED)
        assert "scann_torch_lookalike" not in core.banned_modules()
    finally:
        del sys.modules["scann_torch_lookalike"]


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",)}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "glove100-ah.batch10k", "--seed", "3", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def _no_result(out):
    for line in out.strip().splitlines()[-1:]:
        try:
            assert "correct" not in json.loads(line)
        except ValueError:
            pass


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(spec.ROOT)
    assert p.returncode != 0
    _no_result(p.stdout)


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(str(tmp_path))
    assert p.returncode != 0
    _no_result(p.stdout)


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process: the run itself refuses to
    print a result while a banned module is loaded, and the process
    holds none at its end."""
    code = (
        "import sys, json; sys.path.insert(0, %r);"
        "sys.path.insert(0, %r);"
        "import conftest; r = conftest.run_tiny('sift1m-sq.batch10k');"
        "from portbench.harness import core;"
        "print(json.dumps([r['correct'], core.banned_modules()]))"
        % (spec.ROOT, os.path.dirname(os.path.abspath(__file__))))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [True, []]
