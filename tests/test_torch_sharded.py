"""The port's sharded index (scann_torch.parallel) against
scann_tpu.parallel.mesh on a (2, 2) mesh: four virtual CPU devices for
the JAX package, one 4-rank gloo job of spawned processes for the port
(tests/torch_sharded_job.py), run once for the whole module.

* Search on JAX-built artifacts: the JAX package builds and serializes,
  the port loads and searches, with every keyword argument of
  search_batched: the ah format with SOAR, the sq format under squared L2
  with query spilling, the sq format with cosine, AVQ and SOAR, and a
  PCA-projected searcher through from_searcher.  Ids at the bars of
  tests/test_torch_tree_ah.py (>= 99.9% by membership, distances within
  1e-4 relative; squared L2 with the L2 bar of ROADMAP section 3).
* Layout: from_searcher of single-host JAX indexes loaded into the port
  gives the JAX package's host tables slot for slot.
* Mutation: one scripted upsert / update / delete sequence with a growth
  step leaves equal tables, and the searches agree.
* Persistence both ways: the JAX loader reads the port's serialization.
* Build: the port's build reads recall within 0.02 of the JAX build of
  the same configuration and data; spilled builds are bit-identical to
  in-memory ones; a compute-device build matches the mesh build's recall;
  one data-parallel k-means step is within 1e-5 of the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import scann_tpu
import torch_sharded_job as job_mod
from scann_torch.parallel import launch
from scann_tpu.parallel import mesh as jmesh_mod
from test_torch_tree_ah import _assert_same
import torch_threads  # noqa: F401  (torch threads per xdist worker)

N, D, NQ, N_EXTRA = 4000, 32, 200, 1500
JAX_BUILDS = ("ah_soar", "sq_l2_spill", "sq_cosine_avq_soar")
MEASURE = {"ah_soar": "dot_product", "sq_l2_spill": "squared_l2",
           "sq_cosine_avq_soar": "cosine"}


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _data(seed=5):
    rng = np.random.default_rng(seed)
    topics = rng.standard_normal((60, D)).astype(np.float32)
    x = topics[rng.integers(0, 60, N + N_EXTRA + NQ)] \
        + 0.35 * rng.standard_normal((N + N_EXTRA + NQ, D))
    x = _unit(x)
    return x[:N], x[N:N + N_EXTRA], x[N + N_EXTRA:]


def _configs(db):
    def tree(b, **kw):
        return b.tree(num_leaves=24, num_leaves_to_search=6,
                      training_sample_size=N, **kw)
    return {
        "ah_soar": tree(scann_tpu.builder(db, 10, "dot_product"),
                        soar_lambda=1.5)
        .score_ah(2, anisotropic_quantization_threshold=0.2)
        .reorder(40).create_config(),
        "sq_l2_spill": tree(scann_tpu.builder(db, 10, "squared_l2"),
                            query_spilling_type="additive",
                            query_spilling_threshold=0.3)
        .score_brute_force(quantize="int8").create_config(),
        "sq_cosine_avq_soar": tree(scann_tpu.builder(db, 10, "cosine"),
                                   soar_lambda=1.5, avq=2.5)
        .score_brute_force(quantize="int8").create_config(),
    }


def _recall(idx, truth):
    return np.mean([len(set(r[r >= 0]) & set(t)) / 10
                    for r, t in zip(idx, truth)])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX package's artifacts, searchers and host tables, and the
    port's job results (rank 0's, plus every rank's)."""
    work = str(tmp_path_factory.mktemp("sharded"))
    devs = jax.devices()[:4]
    jmesh = Mesh(np.array(devs).reshape(2, 2), ("data", "shard"))
    db, extra, q = _data()
    rng = np.random.default_rng(11)
    inp = dict(db=db, extra=extra, q=q,
               ks=rng.integers(1, 11, NQ),
               allow=rng.random(N + N_EXTRA + 200) < 0.5,
               attrs=rng.integers(0, 4, N + N_EXTRA + 200).astype(np.int32),
               kmeans_x=rng.standard_normal((4096, 16)).astype(np.float32),
               kmeans_c0=rng.standard_normal((32, 16)).astype(np.float32),
               kmeans_valid=4000)
    js = {}
    for name, config in _configs(db).items():
        js[name] = jmesh_mod.build_sharded(db, config, jmesh)
        js[name].serialize(os.path.join(work, "jax_" + name))
    centers = np.asarray(js["ah_soar"].state["centers"])
    inp["pretok"] = np.argsort(-(q @ centers.T), axis=1)[:, :5].astype(
        np.int32)
    inp["pretok"][::3, 4] = -1
    singles = {
        "pca": scann_tpu.builder(db, 10, "dot_product")
        .tree(num_leaves=16, num_leaves_to_search=6, training_sample_size=N)
        .pca(reduction_dim=20, pca_significance_threshold=None)
        .score_ah(2, anisotropic_quantization_threshold=float("nan"))
        .reorder(40).build(),
        "tree_ah": scann_tpu.builder(db, 10, "dot_product")
        .tree(num_leaves=24, num_leaves_to_search=6, training_sample_size=N)
        .score_ah(2, anisotropic_quantization_threshold=0.2)
        .reorder(40).build(),
        "tree_sq": scann_tpu.builder(db, 10, "squared_l2")
        .tree(num_leaves=24, num_leaves_to_search=6, training_sample_size=N)
        .score_brute_force(quantize="int8").build(),
    }
    from_single = {}
    for name, s in singles.items():
        s.serialize(os.path.join(work, "jax_single_" + name))
        from_single[name] = jmesh_mod.ShardedTreeAHSearcher.from_searcher(
            s, db, jmesh)
    from_single["pca"].serialize(os.path.join(work, "jax_from_pca"))
    np.savez(os.path.join(work, "inputs.npz"), **inp)
    ranks = launch.spawn(job_mod.job, 2, 2, work, device_type="cpu")
    flat = Mesh(np.array(devs), ("data",))
    xs = jax.device_put(jnp.asarray(inp["kmeans_x"]),
                        NamedSharding(flat, P("data", None)))
    step = np.asarray(jmesh_mod.sharded_kmeans_step(
        xs, jnp.asarray(inp["kmeans_c0"]), flat,
        valid_rows=inp["kmeans_valid"]))
    return dict(work=work, jmesh=jmesh, inp=inp, js=js, singles=singles,
                from_single=from_single, ranks=ranks, port=ranks[0],
                kmeans_step=step)


# After the mutation, the cases searched on the JAX side (each new set of
# keyword arguments compiles a JAX program; per-query k and the epsilons
# reuse the default's).
MUTATION_CASES = ("default", "restrict", "pre_crowding", "per_query_k")
PERSIST_CASES = ("default", "crowding", "epsilon_per_query")


def _jax_search(s, inp, measure, cases):
    s.set_crowding(inp["attrs"][:s.n_points])
    kws = job_mod.search_kwargs(inp, measure)
    return {name: s.search_batched(inp["q"], **kws[name]) for name in cases}


def _l2(measure):
    return "squared_l2" if measure == "squared_l2" else "dot_product"


def test_job_ranks_agree(run):
    """The (2, 2) mesh's coordinates, and every rank returns the whole
    batch with the same answers (the data group's all-gather)."""
    ranks = run["ranks"]
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks[1:]:
        for name in JAX_BUILDS:
            for case, (i, d) in r[name]["search"].items():
                i0, d0 = run["port"][name]["search"][case]
                np.testing.assert_array_equal(i, i0, err_msg=case)
                np.testing.assert_array_equal(d, d0, err_msg=case)


@pytest.mark.parametrize("name", JAX_BUILDS)
@pytest.mark.parametrize("case", sorted(job_mod.search_kwargs(
    {"q": np.zeros((NQ, D)), "ks": None, "allow": None, "pretok": None},
    "dot_product")))
def test_search_on_jax_artifacts(run, name, case):
    js = run["js"][name]
    kw = job_mod.search_kwargs(run["inp"], MEASURE[name])[case]
    js.set_crowding(run["inp"]["attrs"][:js.n_points])
    want = js.search_batched(run["inp"]["q"], **kw)
    got = run["port"][name]["search"][case]
    _assert_same(want, got, _l2(MEASURE[name]))


@pytest.mark.parametrize("name", JAX_BUILDS)
def test_loaded_tables_equal(run, name):
    hp = run["js"][name]._host_parts
    for key, got in run["port"][name]["loaded_tables"].items():
        np.testing.assert_array_equal(got, np.asarray(hp[key]), err_msg=key)


@pytest.mark.parametrize("name", ["pca", "tree_ah", "tree_sq"])
def test_from_searcher_layout_slot_for_slot(run, name):
    """from_searcher of a JAX-built single index loaded into the port: the
    JAX package's host tables, slot for slot, and its search."""
    hp = run["from_single"][name]._host_parts
    got = run["port"]["from_" + name]["tables"]
    for key in ("codes", "slot_leaf", "slot_dpid", "rows_i8"):
        np.testing.assert_array_equal(got[key], np.asarray(hp[key]),
                                      err_msg=key)
    for key in ("rows_sq", "rows_scale"):
        np.testing.assert_allclose(got[key], np.asarray(hp[key]),
                                   rtol=1e-6, err_msg=key)
    measure = "squared_l2" if name == "tree_sq" else "dot_product"
    want = run["from_single"][name].search_batched(run["inp"]["q"])
    _assert_same(want, run["port"]["from_" + name]["search"], measure)


def test_projected_searcher_on_jax_artifacts(run):
    """The JAX package's sharded PCA index (absolute rows in the original
    space, proj_matrix in the assets) loaded into the port."""
    want = run["from_single"]["pca"].search_batched(run["inp"]["q"])
    _assert_same(want, run["port"]["jax_from_pca"]["search"])


@pytest.fixture(scope="module")
def mutated(run):
    """The JAX searchers after the job's scripted mutation."""
    out = {}
    for name in ("ah_soar", "sq_l2_spill"):
        js = jmesh_mod.load_sharded(os.path.join(run["work"], "jax_" + name),
                                    run["jmesh"])
        n_over = job_mod.mutate(js, run["inp"]["extra"], js.n_points)
        assert n_over == run["port"][name]["n_over"]
        out[name] = js
    return out


@pytest.mark.parametrize("name", ["ah_soar", "sq_l2_spill"])
def test_mutation_tables_slot_for_slot(run, mutated, name):
    """The tables after the scripted mutation are the JAX package's; on
    every rank its shard's device tables are its host tables, and only
    the growth re-uploaded them whole (the other writes went slot by
    slot)."""
    for r in run["ranks"]:
        assert r[name]["state_is_host"] and r[name]["refreshes"] == 1
    hp = mutated[name]._host_parts
    got = run["port"][name]["mutated_tables"]
    assert got["slot_dpid"].shape[1] > run["port"][name][
        "loaded_tables"]["slot_dpid"].shape[1]          # the layout grew
    for key in job_mod.TABLE_KEYS:
        np.testing.assert_array_equal(got[key], np.asarray(hp[key]),
                                      err_msg=key)


@pytest.mark.parametrize("name", ["ah_soar", "sq_l2_spill"])
def test_mutation_searches_agree(run, mutated, name):
    want = _jax_search(mutated[name], run["inp"], MEASURE[name],
                       MUTATION_CASES)
    got = run["port"][name]["mutated_search"]
    for case in want:
        _assert_same(want[case], got[case], _l2(MEASURE[name]))


@pytest.mark.parametrize("name", ["ah_soar", "sq_l2_spill"])
def test_jax_loads_the_port_serialization(run, mutated, name):
    """Persistence the other way: the JAX loader reads the port's mutated
    index, its tables are the JAX package's own mutation's, and its
    searches agree with the port's."""
    js = jmesh_mod.load_sharded(os.path.join(run["work"], "port_" + name),
                                run["jmesh"])
    for key in job_mod.TABLE_KEYS:
        np.testing.assert_array_equal(np.asarray(js._host_parts[key]),
                                      np.asarray(mutated[name]._host_parts[
                                          key]), err_msg=key)
    want = _jax_search(js, run["inp"], MEASURE[name], PERSIST_CASES)
    got = run["port"][name]["mutated_search"]
    for case in want:
        _assert_same(want[case], got[case], _l2(MEASURE[name]))


def _truth(inp, measure):
    db, q = inp["db"], inp["q"]
    if measure == "squared_l2":
        return np.argsort(((q[:, None, :] - db[None]) ** 2).sum(-1),
                          axis=1)[:, :10]
    return np.argsort(-(q @ db.T), axis=1)[:, :10]   # unit rows and queries


@pytest.mark.parametrize("name", JAX_BUILDS)
def test_port_build_recall_matches_jax_build(run, name):
    q = run["inp"]["q"]
    truth = _truth(run["inp"], MEASURE[name])
    want = _recall(run["js"][name].search_batched(q)[0], truth)
    got = _recall(run["port"]["build_" + name]["search"][0], truth)
    per_row = 2 if run["js"][name].part_cfg.soar is not None else 1
    assert run["port"]["build_" + name]["live"] == per_row * N
    assert abs(got - want) <= 0.02, (got, want)


def test_spill_build_is_bit_identical(run):
    sp = run["port"]["spill"]
    for key in job_mod.TABLE_KEYS:
        np.testing.assert_array_equal(sp["spill"][key], sp["mem"][key],
                                      err_msg=key)
    for a, b in zip(sp["spill_search"], sp["mem_search"]):
        np.testing.assert_array_equal(a, b)
    assert os.path.exists(os.path.join(run["work"], "spill",
                                       "layout_rows.npy"))


def test_compute_device_build_matches_mesh_build(run):
    truth = _truth(run["inp"], "squared_l2")
    sp = run["port"]["spill"]
    assert _recall(sp["compute_search"][0], truth) >= \
        _recall(sp["mem_search"][0], truth) - 0.03


def test_lloyd_build_path(run):
    """The data-parallel Lloyd steps (random initial centers drawn from
    the sample, sums and counts all-reduced, no reseeding) against the
    single k-means engine on the same configuration: within 0.05."""
    truth = _truth(run["inp"], "squared_l2")
    got = _recall(run["port"]["build_lloyd"]["search"][0], truth)
    want = _recall(run["port"]["build_sq_l2_spill"]["search"][0], truth)
    assert got >= want - 0.05, (got, want)


def test_sharded_kmeans_step_matches_jax(run):
    np.testing.assert_allclose(run["port"]["kmeans_step"],
                               run["kmeans_step"], rtol=1e-5, atol=1e-5)
    for r in run["ranks"][1:]:
        np.testing.assert_array_equal(r["kmeans_step"],
                                      run["port"]["kmeans_step"])


def test_dryrun_on_the_job_mesh(run):
    assert "OK; mesh={'data': 2, 'shard': 2}" in run["port"]["dryrun"]
