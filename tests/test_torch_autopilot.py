"""Autopilot (ROADMAP item 17) against scann_tpu: ``autopilot_rewrite``
writes the JAX package's config JSON over a grid of both heuristic sets,
both engines, three measures, the incremental modes, target recalls, and
corpus sizes on both sides of every bound; ``builder(...).autopilot()``
rewrites in the factory and the result builds and searches on the CPU.
The rewrite reads only the corpus's shape, so the grid passes
zero-stride arrays of any size."""

import dataclasses
import math

import numpy as np
import pytest

import scann_torch
import scann_tpu
from scann_torch import config as tcfg
from scann_torch.utils import autopilot as tap
from scann_tpu import config as jcfg
from scann_tpu.utils import autopilot as jap
import torch_threads  # noqa: F401  (torch threads per xdist worker)


def _shape_only(n, d):
    return np.broadcast_to(np.float32(0), (n, d))


def _sizes(heuristics, dim, k):
    """Corpus sizes around each bound of the rewrite."""
    if heuristics == "tpu":
        bound = 16 * tap._TPU_LEAF_ROWS
        sizes = [bound - 1, bound, 8 * bound, 50_000, 1_183_514]
    else:
        leaf = max(math.ceil(tap._AH_SIZE * 2 * tap._L1_SIZE / dim),
                   tap._SAFETY * tap._KMEANS_STABLE_SIZE)
        nn = math.ceil(max(2.0 * k, 100 * math.sqrt(k)))
        bound = max(tap._SAFETY * nn, tap._MAGIC * leaf)
        sizes = [bound - 1, bound, 2 * bound, 1_183_514]
    # Past the tokenization / L3 / training caps.
    return sizes + [10_000_000, 100_000_000]


@pytest.mark.parametrize("mode", [None, "online", "online_incremental"])
@pytest.mark.parametrize("measure", ["dot_product", "squared_l2", "cosine"])
@pytest.mark.parametrize("engine", ["tree_ah", "tree_sq"])
@pytest.mark.parametrize("heuristics", ["tpu", "reference"])
def test_rewrite_json_equals_jax(heuristics, engine, measure, mode):
    for dim in (8, 100, 960):
        for k in (1, 10, 100):
            for target in (0.5, 0.9, 0.95, 0.975, 0.99):
                for quantize in ("float32", "int8", "bfloat16"):
                    auto = dict(
                        incremental_mode="none" if mode is None else mode,
                        reordering_dtype=quantize, engine=engine,
                        heuristics=heuristics, target_recall=target)
                    tc = tcfg.ScannConfig(
                        num_neighbors=k, distance_measure=measure,
                        autopilot=tcfg.AutopilotConfig(**auto), seed=7)
                    jc = jcfg.ScannConfig(
                        num_neighbors=k, distance_measure=measure,
                        autopilot=jcfg.AutopilotConfig(**auto), seed=7)
                    for n in _sizes(heuristics, dim, k):
                        db = _shape_only(n, dim)
                        got = tap.autopilot_rewrite(tc, db).to_json()
                        want = jap.autopilot_rewrite(jc, db).to_json()
                        assert got == want, (n, dim, k, target, quantize)


def test_scan_fraction_and_dim_zero():
    for curve in (tap._RECALL_CURVE, tap._RECALL_CURVE_SQ):
        assert curve == (jap._RECALL_CURVE if curve is tap._RECALL_CURVE
                         else jap._RECALL_CURVE_SQ)
        for r in np.linspace(0.5, 0.999, 41):
            assert tap._scan_fraction(r, curve) == \
                jap._scan_fraction(r, curve)
    c = tcfg.ScannConfig(autopilot=tcfg.AutopilotConfig())
    with pytest.raises(ValueError, match="dim == 0"):
        tap.autopilot_rewrite(c, _shape_only(10, 0))


@pytest.mark.parametrize("engine,measure", [
    ("tree_ah", "dot_product"), ("tree_sq", "cosine")])
def test_builder_autopilot_builds_jax_config_and_searches(engine, measure):
    r = np.random.default_rng(0)
    c = r.standard_normal((80, 16))
    db = (c[r.integers(0, 80, 8000)]
          + 0.3 * r.standard_normal((8000, 16))).astype(np.float32)
    q = db[:20] + 0.01
    s = scann_torch.builder(db, 10, measure, device="cpu").autopilot(
        engine=engine).build()
    jb = scann_tpu.builder(db, 10, measure).autopilot(engine=engine)
    rows = db
    if measure == "cosine":
        rows = db / np.linalg.norm(db, axis=1, keepdims=True)
    want = jap.autopilot_rewrite(jb.create_config(), rows)
    got = tap.autopilot_rewrite(
        scann_torch.builder(db, 10, measure, device="cpu").autopilot(
            engine=engine).create_config(), rows)
    assert got.to_json() == want.to_json()
    # The searcher holds that config; the build may split oversized
    # leaves, which raises num_leaves.
    assert s.part_cfg.num_leaves >= want.partitioning.num_leaves
    assert s.config.to_json() == dataclasses.replace(
        got, partitioning=dataclasses.replace(
            got.partitioning, num_leaves=s.part_cfg.num_leaves)).to_json()
    idx, dist = s.search_batched(q)
    assert idx.shape == (20, 10) and np.isfinite(dist).all()
    qq = q if measure == "dot_product" else \
        q / np.linalg.norm(q, axis=1, keepdims=True)
    sim = qq @ rows.T
    truth = np.argsort(-sim, axis=1)[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(idx, truth)])
    assert recall >= 0.8, recall
    assert type(s).__name__ == ("TreeXSearcher" if engine == "tree_sq"
                                else "TreeAHSearcher")


def test_builder_autopilot_arguments_match_jax():
    db = np.zeros((10, 4), np.float32)
    for kw in (dict(), dict(mode="online", quantize="int8"),
               dict(mode="online_incremental", heuristics="reference",
                    target_recall=0.9, engine="tree_sq")):
        got = scann_torch.builder(db, 3, "dot_product", device="cpu"
                                  ).autopilot(**kw).create_config()
        want = scann_tpu.builder(db, 3, "dot_product").autopilot(
            **kw).create_config()
        assert got.to_json() == want.to_json()
    b = scann_torch.builder(db, 3, "dot_product", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        b.autopilot(engine="x")
    with pytest.raises(ValueError, match="heuristics"):
        b.autopilot(heuristics="x")
