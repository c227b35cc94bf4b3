"""Card tests of the sharded index (marker ``cuda``; they skip without a
card): a (1, 1) NCCL mesh on the card against a (1, 1) gloo mesh on the
CPU, one process group at a time in this process.  Indexes built and
serialized on the CPU (the ah format with SOAR, the sq format under
squared L2) are loaded on the card; its searches return the CPU's (ids
>= 99.9% by membership, distances within 1e-4 relative plus 1e-6), and
one scripted upsert / update / delete sequence with a growth step leaves
the CPU's tables (the AH codes of the new rows >= 99.9%: the encoder's
float32 sums run in another order on the card).  On a machine with a
card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_sharded.py
"""

import numpy as np
import pytest
import torch

import scann_torch
from scann_torch.parallel import build as build_mod
from scann_torch.parallel import launch
from scann_torch.parallel import mesh as mesh_mod
import torch_threads  # noqa: F401  (torch threads per xdist worker)

pytestmark = pytest.mark.cuda

N, D, NQ = 20000, 48, 500
KEYS = ("slot_leaf", "slot_dpid", "rows_i8", "rows_sq", "rows_scale",
        "codes")


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _data(seed=3):
    rng = np.random.default_rng(seed)
    topics = rng.standard_normal((300, D)).astype(np.float32)
    x = _unit(topics[rng.integers(0, 300, N + 3000 + NQ)]
              + 0.3 * rng.standard_normal((N + 3000 + NQ, D)))
    return x[:N], x[N:N + 3000], x[N + 3000:]


def _config(fmt, db):
    if fmt == "ah":
        return (scann_torch.builder(db, 10, "dot_product", device="cpu")
                .tree(num_leaves=64, num_leaves_to_search=8,
                      training_sample_size=N, soar_lambda=1.5)
                .score_ah(2, anisotropic_quantization_threshold=0.2)
                .reorder(40).create_config())
    return (scann_torch.builder(db, 10, "squared_l2", device="cpu")
            .tree(num_leaves=64, num_leaves_to_search=8,
                  training_sample_size=N)
            .score_brute_force(quantize="int8").create_config())


def _mutate(s, extra):
    first = s.n_points
    per_row = 2 if s.part_cfg.soar is not None else 1
    # Half the free slots first, then one row more than the rest hold.
    n_new = max(4, int((s._host_parts["slot_dpid"] < 0).sum()) // per_row
                // 2)
    s.upsert(np.arange(first, first + n_new), extra[:n_new])
    s.upsert([3, 7, 11], extra[n_new:n_new + 3])
    s.delete([5, first + 1, first + 2])
    free = int((s._host_parts["slot_dpid"] < 0).sum())
    n_over = free // per_row + 1
    s.upsert(np.arange(first + n_new, first + n_new + n_over),
             extra[n_new + 3:n_new + 3 + n_over])
    assert s._shard_slots > s._shard_chunk          # the layout grew


def _tables(s):
    hp = s.gather_host_parts()
    return {k: np.array(hp[k]) for k in KEYS}


def _same(want, got):
    (wi, wd), (gi, gd) = want, got
    match = wi[:, :, None] == gi[:, None, :]
    assert match.any(-1).mean() >= 0.999, match.any(-1).mean()
    gd_of = np.take_along_axis(gd, match.argmax(-1), axis=1)
    same = match.any(-1) & (wi >= 0)
    np.testing.assert_allclose(gd_of[same], wd[same], rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def cpu_side(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    work = tmp_path_factory.mktemp("sharded_cuda")
    db, extra, q = _data()
    out = {"db": db, "extra": extra, "q": q}
    mesh = launch.init_mesh(1, 1, device_type="cpu")
    try:
        for fmt in ("ah", "sq"):
            s = build_mod.build_sharded(db, _config(fmt, db), mesh)
            s.serialize(str(work / fmt))
            rec = {"dir": str(work / fmt), "search": s.search_batched(q)}
            _mutate(s, extra)
            rec["tables"] = _tables(s)
            rec["mutated_search"] = s.search_batched(q)
            out[fmt] = rec
    finally:
        launch.close()
    return out


@pytest.fixture
def card_mesh():
    mesh = launch.init_mesh(1, 1, device_type="cuda")
    yield mesh
    launch.close()


@pytest.mark.parametrize("fmt", ["ah", "sq"])
def test_card_search_equals_cpu(cpu_side, card_mesh, fmt):
    s = mesh_mod.load_sharded(cpu_side[fmt]["dir"], card_mesh)
    assert s.state["rows_i8"].is_cuda
    _same(cpu_side[fmt]["search"], s.search_batched(cpu_side["q"]))


@pytest.mark.parametrize("fmt", ["ah", "sq"])
def test_card_mutation_gives_the_cpu_tables(cpu_side, card_mesh, fmt):
    s = mesh_mod.load_sharded(cpu_side[fmt]["dir"], card_mesh)
    _mutate(s, cpu_side["extra"])
    got, want = _tables(s), cpu_side[fmt]["tables"]
    for key in KEYS[:-1]:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got["codes"] == want["codes"]).all(-1).mean() >= 0.999
    for key in KEYS[:-1]:
        np.testing.assert_array_equal(s.state[key].cpu().numpy(),
                                      got[key][0], err_msg=key)
    _same(cpu_side[fmt]["mutated_search"], s.search_batched(cpu_side["q"]))
