"""Reference-format index directories (ROADMAP item 17) against
scann_tpu: the golden wire fixtures decode to the same values in both
packages; the encoders write the JAX package's bytes; a directory the
JAX package writes loads into the port and searches as the JAX searcher
does (ids >= 99.9% equal); one the port writes loads into the JAX
package; save_reference_assets writes the JAX package's files byte for
byte for the same index; the residual-int8 refusal and its lossy
downgrade match; docids travel both ways."""

import os
import pickle

import numpy as np
import pytest

import scann_torch
import scann_tpu
from scann_torch.utils import ref_assets as tra
from scann_tpu.utils import ref_assets as jra
import torch_threads  # noqa: F401  (torch threads per xdist worker)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def make_data(n=3000, d=24, nq=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((20, d)).astype(np.float32)
    db = (centers[rng.integers(0, 20, n)]
          + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    q = rng.standard_normal((nq, d)).astype(np.float32)
    return db, q


def _ids_agree(a, b):
    return float(np.mean(np.asarray(a) == np.asarray(b)))


# ------------------------------------------------------------ wire codec
@pytest.mark.parametrize("name,key", [
    ("golden_codebook16.pb", "cb16"), ("golden_codebook256.pb", "cb256")])
def test_golden_codebooks_decode_equal(name, key):
    exp = np.load(os.path.join(DATA, "golden_ref_expected.npz"))
    got = tra.decode_codebook(_read(name))
    np.testing.assert_array_equal(got, jra.decode_codebook(_read(name)))
    np.testing.assert_array_equal(got, exp[key])


@pytest.mark.parametrize("name", ["golden_partitioner_flat.pb",
                                  "golden_partitioner_hier.pb"])
def test_golden_partitioners_decode_equal(name):
    exp = np.load(os.path.join(DATA, "golden_ref_expected.npz"))
    got = tra.decode_partitioner_tree(_read(name))
    want = jra.decode_partitioner_tree(_read(name))
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    key = "flat_centers" if "flat" in name else "leaf_centers"
    np.testing.assert_allclose(got[0], exp[key], rtol=1e-6)


def _configs(db):
    out = []
    for pkg in (scann_torch, scann_tpu):
        kw = {"device": "cpu"} if pkg is scann_torch else {}
        out.append([
            pkg.builder(db, 10, "dot_product", **kw)
            .tree(num_leaves=16, num_leaves_to_search=4, soar_lambda=1.2,
                  overretrieve_factor=2.5, avq=1.0)
            .score_ah(2, anisotropic_quantization_threshold=0.2)
            .reorder(50, quantize="int8").create_config(),
            pkg.builder(db, 7, "squared_l2", **kw)
            .tree(num_leaves=9, num_leaves_to_search=3,
                  query_spilling_type="additive",
                  query_spilling_threshold=0.5, quantize_centroids=True)
            .score_ah(4, hash_type="lut256").reorder(20, "bfloat16")
            .create_config(),
            pkg.builder(db, 5, "cosine", **kw).score_brute_force("int8")
            .create_config(),
            pkg.builder(db, 5, "dot_product", **kw)
            .score_brute_force("bfloat16").reorder(30).create_config()])
    return zip(*out)


def test_encoders_write_jax_bytes():
    db, _ = make_data(n=200)
    for tc, jc in _configs(db):
        assert tc.to_json() == jc.to_json()
        buf = tra.encode_scann_config(tc)
        assert buf == jra.encode_scann_config(jc)
        assert tra.decode_scann_config(buf).to_json() == \
            jra.decode_scann_config(buf).to_json()
    r = np.random.default_rng(1)
    cb = r.standard_normal((5, 16, 2)).astype(np.float32)
    assert tra.encode_codebook(cb) == jra.encode_codebook(cb)
    centers = r.standard_normal((7, 6)).astype(np.float32)
    assert tra.encode_partitioner(centers) == jra.encode_partitioner(centers)
    assets = [("AH_CENTERS", "ah_codebook.pb"),
              ("TOKENIZATION_NPY", "datapoint_to_token.npy")]
    text = tra.emit_assets_pbtxt(assets)
    assert text == jra.emit_assets_pbtxt(assets)
    assert tra.parse_assets_pbtxt(text) == assets
    l1 = scann_torch.builder(db, 3, "l1", device="cpu").score_brute_force(
    ).create_config()
    with pytest.raises(ValueError, match="no reference-format"):
        tra.encode_scann_config(l1)


# ------------------------------------------------------- directories
@pytest.fixture(scope="module")
def jax_indexes(tmp_path_factory):
    """JAX-built indexes, each serialized (the port loads the same index
    with load_searcher) and written as a reference directory."""
    db, q = make_data()
    out = {}
    make = {
        "tree_ah": lambda: (scann_tpu.builder(db, 10, "dot_product")
                            .tree(num_leaves=16, num_leaves_to_search=4,
                                  training_sample_size=3000)
                            .score_ah(2, anisotropic_quantization_threshold=0.2)
                            .reorder(50).build()),
        "soar": lambda: (scann_tpu.builder(db, 10, "dot_product")
                         .tree(num_leaves=16, num_leaves_to_search=4,
                               training_sample_size=3000, soar_lambda=1.5)
                         .score_ah(2, anisotropic_quantization_threshold=0.2)
                         .reorder(50, "bfloat16").build()),
        "brute_force": lambda: (scann_tpu.builder(db, 7, "squared_l2")
                                .score_brute_force(quantize="int8").build()),
        "residual": lambda: (scann_tpu.builder(db, 10, "dot_product")
                             .tree(num_leaves=16, num_leaves_to_search=4,
                                   training_sample_size=3000)
                             .score_ah(2).reorder(50, quantize="int8")
                             .build()),
    }
    for name, fn in make.items():
        s = fn()
        root = tmp_path_factory.mktemp(name)
        s.serialize(str(root / "native"))
        if name == "residual":
            scann_tpu.save_reference_assets(s, str(root / "ref"),
                                            lossy_reorder_downgrade=True)
        else:
            scann_tpu.save_reference_assets(s, str(root / "ref"))
        out[name] = (s, root, s.search_batched(q))
    return db, q, out


@pytest.mark.parametrize("name", ["tree_ah", "soar", "brute_force",
                                  "residual"])
def test_jax_written_dir_loads_into_port(jax_indexes, name):
    _, q, out = jax_indexes
    js, root, (jidx, jdist) = out[name]
    ts = scann_torch.load_reference_assets(str(root / "ref"), device="cpu")
    assert type(ts).__name__ == type(js).__name__
    jback = scann_tpu.load_reference_assets(str(root / "ref"))
    want_idx, want_dist = jback.search_batched(q)
    idx, dist = ts.search_batched(q)
    assert _ids_agree(idx, want_idx) >= 0.999
    same = idx == want_idx
    np.testing.assert_allclose(dist[same], want_dist[same], rtol=1e-5,
                               atol=1e-5)
    if name != "residual":
        # The lossless formats search as the original JAX index.
        assert _ids_agree(idx, jidx) >= 0.999
    if name == "soar":
        assert ts.datapoint_to_token.shape == (ts.n_points, 2)
        np.testing.assert_array_equal(ts._host["dpid"], jback._host["dpid"])
        np.testing.assert_array_equal(ts._host["codes"],
                                      jback._host["codes"])


def _files(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


@pytest.mark.parametrize("name", ["tree_ah", "soar", "brute_force",
                                  "residual"])
def test_port_writes_jax_bytes_and_jax_loads_them(jax_indexes, name,
                                                  tmp_path):
    _, q, out = jax_indexes
    js, root, (jidx, _) = out[name]
    ts = scann_torch.load_searcher(str(root / "native"), device="cpu")
    kw = {"lossy_reorder_downgrade": True} if name == "residual" else {}
    scann_torch.save_reference_assets(ts, str(tmp_path), **kw)
    assert _files(str(tmp_path)) == _files(str(root / "ref"))
    back = scann_tpu.load_reference_assets(str(tmp_path))
    assert _ids_agree(back.search_batched(q)[0],
                      ts.search_batched(q)[0] if name != "residual"
                      else scann_torch.load_reference_assets(
                          str(tmp_path), device="cpu").search_batched(q)[0]
                      ) >= 0.999


def test_residual_refusal_matches_jax(jax_indexes, tmp_path):
    _, _, out = jax_indexes
    js, root, _ = out["residual"]
    ts = scann_torch.load_searcher(str(root / "native"), device="cpu")
    with pytest.raises(ValueError) as want:
        scann_tpu.save_reference_assets(js, str(tmp_path / "j"))
    with pytest.raises(ValueError) as got:
        scann_torch.save_reference_assets(ts, str(tmp_path / "t"))
    assert str(got.value) == str(want.value)
    tx = scann_torch.builder(np.zeros((300, 8), np.float32) + np.arange(8),
                             3, "dot_product", device="cpu").tree(
        4, 2).score_brute_force("int8").build()
    with pytest.raises(ValueError, match="no reference-format equivalent"):
        scann_torch.save_reference_assets(tx, str(tmp_path / "x"))


def test_port_built_index_round_trips(tmp_path):
    """A port-built tree-AH index: written by the port, loaded by both
    packages, each searching as the port index does; docids travel."""
    db, q = make_data(n=1500, seed=3)
    docids = [f"doc-{i}" for i in range(len(db))]
    s = (scann_torch.builder(db, 5, "dot_product", device="cpu")
         .tree(num_leaves=8, num_leaves_to_search=3,
               training_sample_size=1500)
         .score_ah(2).reorder(20).build(docids=docids))
    want = s.search_batched(q)[0]
    scann_torch.save_reference_assets(s, str(tmp_path))
    assert pickle.load(open(tmp_path / "scann_docids.pkl", "rb")) == docids
    back = scann_torch.load_reference_assets(str(tmp_path), device="cpu")
    assert back.docids == docids
    assert back.search_batched(q)[0] == want
    jback = scann_tpu.load_reference_assets(str(tmp_path))
    assert jback.docids == docids
    got = jback.search_batched(q)[0]
    agree = np.mean([a == b for ra, rb in zip(got, want)
                     for a, b in zip(ra, rb)])
    assert agree >= 0.999
