"""The port's sharded build and its edges on a (1, 1) gloo mesh in this
process: the disk-spilled build against the in-memory one and its crash
resume (the cases of tests/test_spill_build.py), the reservoir sample
against the JAX package's, health stats, and the errors the JAX package
raises.  The process group is closed after the module."""

import json
import os

import numpy as np
import pytest
import torch

import scann_torch
from scann_torch.parallel import build as build_mod
from scann_torch.parallel import launch
from scann_torch.parallel import layout as layout_mod
from scann_torch.parallel import mesh as mesh_mod
from scann_tpu.parallel import mesh as jmesh_mod
import torch_threads  # noqa: F401  (torch threads per xdist worker)

N_CHUNKS, CHUNK_ROWS, D = 4, 3000, 32


@pytest.fixture(scope="module")
def mesh():
    m = launch.init_mesh(1, 1, device_type="cpu")
    yield m
    launch.close()


@pytest.fixture(scope="module")
def topics():
    rng = np.random.default_rng(31)
    t = rng.standard_normal((200, D)).astype(np.float32)
    return t / np.linalg.norm(t, axis=1, keepdims=True)


def make_chunk(ci, topics):
    r = np.random.default_rng(700 + ci)
    x = (topics[r.integers(0, len(topics), CHUNK_ROWS)]
         + 0.1 * r.standard_normal((CHUNK_ROWS, D)).astype(np.float32))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def chunks_fn(topics):
    def chunks():
        for ci in range(N_CHUNKS):
            yield make_chunk(ci, topics)
    return chunks


def make_config(fmt):
    b = (scann_torch.builder(np.zeros((1, D), np.float32), 10,
                             "dot_product", device="cpu")
         .tree(num_leaves=16, num_leaves_to_search=8,
               training_sample_size=4000, random_init=False,
               soar_lambda=1.5))
    if fmt == "sq":
        b = b.score_brute_force(quantize="int8")
    else:
        b = b.score_ah(2, anisotropic_quantization_threshold=0.2)
    return b.create_config()


def assert_same_index(ss_a, ss_b):
    for key in ("slot_leaf", "slot_dpid", "rows_i8", "rows_sq",
                "rows_scale", "codes"):
        np.testing.assert_array_equal(np.asarray(ss_a._host_parts[key]),
                                      np.asarray(ss_b._host_parts[key]),
                                      err_msg=key)


@pytest.mark.parametrize("fmt", ["sq", "ah"])
def test_spill_build_bit_parity(mesh, tmp_path, fmt, topics):
    cfg_ = make_config(fmt)
    ss_mem = build_mod.build_sharded_streaming(chunks_fn(topics), cfg_, mesh)
    ss_spill = build_mod.build_sharded_streaming(
        chunks_fn(topics), cfg_, mesh, spill_dir=str(tmp_path / "spill"))
    assert_same_index(ss_mem, ss_spill)
    q = make_chunk(99, topics)[:16]
    i1, d1 = ss_mem.search_batched(q)
    i2, d2 = ss_spill.search_batched(q)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
    for name in ("phase1.npz", "encode_progress.json", "layout_rows.npy"):
        assert (tmp_path / "spill" / name).exists()


def test_spill_build_crash_resume(mesh, tmp_path, topics):
    """A build killed mid-encode resumes from the last completed chunk
    (phases 1-2 restore from phase1.npz) and emits the same index."""
    cfg_ = make_config("sq")
    spill = str(tmp_path / "spill")
    calls = {"n": 0}

    def crashing_chunks():
        calls["n"] += 1
        gen = calls["n"]

        def gen_chunks():
            for ci in range(N_CHUNKS):
                # Pass 1 samples (and checkpoints phases 1-2); pass 2
                # encodes and dies after chunk 2 is spilled.
                if gen == 2 and ci == 2:
                    raise RuntimeError("simulated crash mid-encode")
                yield make_chunk(ci, topics)
        return gen_chunks()

    with pytest.raises(RuntimeError, match="simulated crash"):
        build_mod.build_sharded_streaming(crashing_chunks, cfg_, mesh,
                                          spill_dir=spill)
    with open(os.path.join(spill, "encode_progress.json")) as f:
        prog = json.load(f)
    assert prog["chunks_done"] == 2
    assert prog["rows_done"] == 2 * CHUNK_ROWS
    ss = build_mod.build_sharded_streaming(chunks_fn(topics), cfg_, mesh,
                                           spill_dir=spill)
    n = N_CHUNKS * CHUNK_ROWS
    assert (np.asarray(ss._host_parts["slot_dpid"]) >= 0).sum() == 2 * n
    ss_mem = build_mod.build_sharded_streaming(chunks_fn(topics), cfg_, mesh)
    assert_same_index(ss_mem, ss)


def test_spill_partial_chunk_truncated(mesh, tmp_path, topics, monkeypatch):
    """A crash between the file writes and the progress commit leaves a
    partial chunk in the spill files; resume truncates it."""
    cfg_ = make_config("sq")
    spill = str(tmp_path / "spill")
    orig_commit = layout_mod._SpillEncodeSink.commit

    def crashing_commit(self, chunks_done, rows_done):
        if chunks_done == 2:
            raise RuntimeError("crash before commit")
        return orig_commit(self, chunks_done, rows_done)

    monkeypatch.setattr(layout_mod._SpillEncodeSink, "commit",
                        crashing_commit)
    with pytest.raises(RuntimeError, match="crash before commit"):
        build_mod.build_sharded_streaming(chunks_fn(topics), cfg_, mesh,
                                          spill_dir=spill)
    monkeypatch.setattr(layout_mod._SpillEncodeSink, "commit", orig_commit)
    with open(os.path.join(spill, "encode_progress.json")) as f:
        assert json.load(f)["chunks_done"] == 1
    ss = build_mod.build_sharded_streaming(chunks_fn(topics), cfg_, mesh,
                                           spill_dir=spill)
    ss_mem = build_mod.build_sharded_streaming(chunks_fn(topics), cfg_, mesh)
    assert_same_index(ss_mem, ss)


@pytest.mark.parametrize("sample_size,chunk", [(500, 300), (5000, 700),
                                               (20000, 4096)])
def test_reservoir_sample_is_the_jax_sample(sample_size, chunk):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((9000, 8)).astype(np.float32)

    def chunks():
        for s in range(0, len(x), chunk):
            yield x[s:s + chunk]

    want = jmesh_mod._reservoir_sample(chunks(), sample_size,
                                       np.random.default_rng(9))
    got = build_mod._reservoir_sample(chunks(), sample_size,
                                      np.random.default_rng(9))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == len(x)


def test_layout_from_parts_is_the_jax_layout():
    """The per-shard leaf sort and padding of every shard's tables (no
    local shard) equal the JAX package's, and a local shard's heavy
    tables are that shard's row of them."""
    rng = np.random.default_rng(2)

    def parts():
        acc = []
        for sh, m in enumerate((700, 0, 1300)):
            acc.append({"codes": [rng.integers(0, 16, (m, 5), np.uint8)],
                        "leaf": [rng.integers(4 * sh, 4 * sh + 4, m)
                                 .astype(np.int32)],
                        "dpid": [rng.permutation(m).astype(np.int32)],
                        "rows": [rng.integers(-127, 128, (m, 9), np.int8)],
                        "sq": [rng.random(m, np.float32)],
                        "scale": [rng.random(m, np.float32)]}
                       if m else {k: [] for k in ("codes", "leaf", "dpid",
                                                  "rows", "sq", "scale")})
        return acc

    state = rng.bit_generator.state
    want = jmesh_mod._layout_shards_from_parts(parts(), 12, 3, 9, 5)
    rng.bit_generator.state = state
    got = layout_mod._layout_shards_from_parts(parts(), 12, 3, 9, 5)
    rng.bit_generator.state = state
    local = layout_mod._layout_shards_from_parts(parts(), 12, 3, 9, 5,
                                                 local_shard=2)
    for key in ("codes", "slot_leaf", "slot_dpid", "rows_i8", "rows_sq",
                "rows_scale", "chunk"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in layout_mod.HEAVY_KEYS:
        np.testing.assert_array_equal(local[key], want[key][2:3])


@pytest.fixture(scope="module")
def small(mesh):
    rng = np.random.default_rng(8)
    db = rng.standard_normal((3000, 16)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    cfg_ = (scann_torch.builder(db, 10, "dot_product", device="cpu")
            .tree(num_leaves=12, num_leaves_to_search=4,
                  training_sample_size=3000)
            .score_ah(2, anisotropic_quantization_threshold=0.2)
            .reorder(30).create_config())
    return db, build_mod.build_sharded(db, cfg_, mesh)


def test_health_and_errors(mesh, small, tmp_path):
    db, ss = small
    assert ss.get_health_stats()["sum_partition_sizes"] == len(db)
    q = db[:8]
    with pytest.raises(ValueError, match="set_crowding"):
        ss.search_batched(q, per_crowding_attribute_num_neighbors=2)
    with pytest.raises(ValueError, match="out of range"):
        ss.search_batched(q, pre_tokenized_leaves=np.full((8, 2), 99,
                                                          np.int32))
    with pytest.raises(ValueError, match="per-query"):
        ss.search_batched(q, final_num_neighbors=np.array([3, 4]))
    with pytest.raises(ValueError, match="per-query"):
        ss.search_batched(q, post_reordering_epsilon=np.zeros(3))
    with pytest.raises(KeyError):
        ss.delete([10 ** 7])
    with pytest.raises(ValueError, match="crowding attributes"):
        ss.set_crowding(np.zeros(5))
    ss.serialize(str(tmp_path / "idx"))
    meta = json.loads((tmp_path / "idx" / "sharded_config.json").read_text())
    meta["n_shards"] = 2
    (tmp_path / "idx" / "sharded_config.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="sharded 2-way"):
        mesh_mod.load_sharded(str(tmp_path / "idx"), mesh)


def test_streaming_avq_refit_matches_apply_avq(mesh):
    """The streaming AVQ refit (per-leaf statistics accumulated chunk by
    chunk) against the single-host apply_avq on the same pre-refit
    centers: the build without AVQ, same seed, has those centers."""
    from scann_torch.ops import kmeans as kmeans_ops
    from scann_torch.partitioning.kmeans_tree import KMeansTreePartitioner
    rng = np.random.default_rng(3)
    t = rng.standard_normal((40, 16)).astype(np.float32)
    db = t[rng.integers(0, 40, 6000)] + 0.3 * rng.standard_normal((6000, 16))
    db = (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)

    def build(avq):
        c = (scann_torch.builder(db, 10, "dot_product", device="cpu")
             .tree(num_leaves=16, num_leaves_to_search=4,
                   training_sample_size=4000, avq=avq)
             .score_brute_force(quantize="int8").create_config())
        return build_mod.build_sharded(db, c, mesh)

    c_old = build(None).state["centers"]
    c_new = build(2.5).state["centers"].numpy()
    assert not np.allclose(c_old.numpy(), c_new)
    tokens = kmeans_ops.assign(torch.as_tensor(db), c_old)[0].numpy()
    part = KMeansTreePartitioner(centers=c_old, query_distance="dot_product")
    want = part.apply_avq(db, tokens, 2.5,
                          int(np.bincount(tokens).max())).centers.numpy()
    np.testing.assert_allclose(c_new, want, rtol=2e-3, atol=2e-4)


def test_variable_chunks_and_float_lookup_load_in_jax(mesh, tmp_path):
    """A port-built ah index with VARIABLE_CHUNK codes (block_dims in the
    assets) searched with float32 LUTs: the JAX package loads its files on
    a (1, 1) mesh and returns the port's answers."""
    import dataclasses

    import jax
    from jax.sharding import Mesh
    from test_torch_tree_ah import _assert_same
    rng = np.random.default_rng(6)
    t = rng.standard_normal((50, 16)).astype(np.float32)
    x = t[rng.integers(0, 50, 4200)] + 0.3 * rng.standard_normal((4200, 16))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    db, q = x[:4000], x[4000:]
    c = (scann_torch.builder(db, 10, "dot_product", device="cpu")
         .tree(num_leaves=16, num_leaves_to_search=5,
               training_sample_size=4000)
         .score_ah(2, anisotropic_quantization_threshold=0.2,
                   variable_dims_per_block=[4, 4, 2, 2, 2, 2])
         .reorder(30).create_config())
    c = dataclasses.replace(c, asymmetric_hash=dataclasses.replace(
        c.asymmetric_hash, lookup_type="float32"))
    ss = build_mod.build_sharded(db, c, mesh)
    assert ss.model.block_dims is not None and ss.model.num_blocks == 6
    ss.serialize(str(tmp_path))
    js = jmesh_mod.load_sharded(str(tmp_path), Mesh(
        np.array(jax.devices()[:1]).reshape(1, 1), ("data", "shard")))
    _assert_same(js.search_batched(q), ss.search_batched(q))


def test_build_refusals(mesh):
    db = np.zeros((100, 8), np.float32)
    b = scann_torch.builder(db, 10, "dot_product", device="cpu")
    with pytest.raises(ValueError, match="requires tree"):
        build_mod.build_sharded(db, b.score_ah(2).create_config(), mesh)
    proj = (scann_torch.builder(db, 10, "dot_product", device="cpu")
            .tree(num_leaves=4, num_leaves_to_search=2)
            .pca(4, pca_significance_threshold=None).score_ah(2)
            .create_config())
    with pytest.raises(ValueError, match="projections"):
        build_mod.build_sharded(db, proj, mesh)


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.init_mesh(1, 1, device_type="cuda")


def test_mesh_is_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.init_mesh(1, 1)
