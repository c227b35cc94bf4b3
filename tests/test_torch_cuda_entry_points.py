"""Card tests of the kernels' custom ops and the entry points around them
(marker ``cuda``; they skip without a card).  Each op of ops/library.py
launches its kernel on CUDA tensors (its launch counter rises by one) and
agrees with its plain version on the same inputs, moved to the CPU; an
export of a small tree-SQ and tree-AH index round-trips on the card;
serving and reference assets work on the card.  On a machine with a
card (no JAX needed)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_entry_points.py

Tolerances are those of tests/test_torch_cuda.py: K3's LUT, K6, the
plan and the selection kernel are bit-equal, K5's group maxima within
1e-5 relative plus 1e-5 with slot ids >= 99.9% equal, K1 / K2 / K4
unpacked values within 2^-14 relative plus 1e-6 and packed identities
>= 99.9% equal."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import scann_torch
from scann_torch.ops import fused_scan, pruned_lut
from scann_torch.ops import pruned_scan as ps
from scann_torch.ops import pruned_sq
from scann_torch.tools import op_cases
import torch_threads  # noqa: F401  (torch threads per xdist worker)

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cases():
    return op_cases.op_cases()


_COUNTERS = {
    "pruned_sq_score": (pruned_sq, "launches"),
    "pruned_rows_score": (ps, "launches"),
    "pruned_lut_build": None,           # counted once, at the scorer
    "pruned_lut_score": (pruned_lut, "launches_lut"),
    "pruned_codes_score": (pruned_lut, "launches_codes"),
    "fused_scan_groupmax": (fused_scan, "launches"),
    "merge_groups": (ps, "launches_merge"),
    "pruned_plan": (ps, "launches_plan"),
    "pruned_merge": (ps, "launches_select"),
}


def _to(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _hold_packed(got, want):
    va, vb = ps._unpack(got)[0].double(), ps._unpack(want)[0].double()
    ok = (va - vb).abs() <= 2.0 ** -14 * vb.abs() + 1e-6
    assert ok.double().mean() >= 0.999
    assert ((got & 511) == (want & 511)).double().mean() >= 0.999


@pytest.mark.parametrize("name", sorted(_COUNTERS))
def test_op_launches_its_kernel_and_matches_plain(cuda, name):
    op, args, _ = _cases()[name]
    if name == "fused_scan_groupmax":
        # The kernel takes whole 128-query tiles.
        q = args[0]
        args = (torch.nn.functional.pad(q, (0, 0, 0, fused_scan.QT
                                            - q.shape[0])),) + args[1:]
    want = op(*args)
    counter = _COUNTERS[name]
    before = getattr(*counter) if counter else None
    got = op(*(_to(a, cuda) for a in args))
    torch.cuda.synchronize()
    if counter:
        assert getattr(*counter) == before + 1
    got = tuple(g.cpu() for g in got) if isinstance(got, tuple) \
        else got.cpu()
    if name in ("merge_groups", "pruned_lut_build", "pruned_plan",
                "pruned_merge"):
        # K6 reads a fully written block here (the plain K2's output).
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    elif name == "fused_scan_groupmax":
        (gv, gi), (wv, wi) = got, want
        assert torch.all((gv - wv).abs() <= 1e-5 * wv.abs() + 1e-5)
        assert (gi == wi).double().mean() >= 0.999
    else:
        # Inactive items are never written by the kernel: compare the
        # active ones (K3's bit for bit).
        work_tile, _, work_active = args[:3]
        g_pad = got.shape[0]
        mnt = work_tile.shape[0] // g_pad
        act = work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
            g_pad, ps.QG, mnt, got.shape[-1] // mnt)
        a, b = got.reshape(act.shape)[act], want.reshape(act.shape)[act]
        if name == "pruned_lut_score":
            assert torch.equal(a, b)
        else:
            _hold_packed(a, b)


def test_fused_scan_entry_point_pads_to_whole_tiles(cuda):
    op, args, _ = _cases()["fused_scan_groupmax"]
    with pytest.raises(ValueError, match="multiple of 128"):
        op(*(_to(a, cuda) for a in args))
    q, rows, bias, l2 = args
    vals, idx = fused_scan.fused_scan_groupmax(q.to(cuda), rows.to(cuda),
                                               bias.to(cuda), measure_l2=l2)
    assert vals.shape == (q.shape[0], rows.shape[0] // fused_scan.SUB)


def _data(n=20_000, d=48, nq=300, seed=4):
    r = np.random.default_rng(seed)
    c = r.standard_normal((400, d))
    db = c[r.integers(0, 400, n)] + 0.5 * r.standard_normal((n, d))
    q = c[r.integers(0, 400, nq)] + 0.5 * r.standard_normal((nq, d))
    return db.astype(np.float32), q.astype(np.float32)


_RELOAD = """
import sys
import numpy as np
from scann_torch import export
from scann_torch.ops import pruned_lut, pruned_sq
ex = export.load_exported_searcher(sys.argv[1])
idx, dist = ex.search_batched(np.load(sys.argv[2]))
assert pruned_sq.launches + pruned_lut.launches_lut > 0
np.save(sys.argv[3], idx)
"""


@pytest.mark.parametrize("engine", ["tree_sq", "tree_ah"])
def test_export_round_trips_on_the_card(cuda, engine, tmp_path):
    db, q = _data()
    b = scann_torch.builder(db, 10, "dot_product").tree(
        num_leaves=100, num_leaves_to_search=10, training_sample_size=20_000)
    b = (b.score_brute_force(quantize="int8") if engine == "tree_sq"
         else b.score_ah(2, anisotropic_quantization_threshold=0.2)
         .reorder(40))
    s = b.build()
    live = s.search_batched(q)
    path = str(tmp_path / "exp")
    scann_torch.save_exported_searcher(path, s, batch_sizes=(128,))
    ex = scann_torch.load_exported_searcher(path)
    assert ex.meta["platforms"] == ["cuda"]
    counter = (pruned_sq, "launches") if engine == "tree_sq" \
        else (pruned_lut, "launches_lut")
    before = getattr(*counter)
    idx, dist = ex.search_batched(q)          # 300 queries: 3 chunks
    assert getattr(*counter) == before + 3
    assert np.mean(idx == live[0]) >= 0.999
    np.save(tmp_path / "q.npy", q)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _RELOAD, path,
                           str(tmp_path / "q.npy"), str(tmp_path / "i.npy")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert np.mean(np.load(tmp_path / "i.npy") == live[0]) >= 0.999


def test_serving_and_reference_assets_on_the_card(cuda, tmp_path):
    import http.client
    import json
    db, q = _data(seed=5)
    s = (scann_torch.builder(db, 10, "dot_product")
         .tree(num_leaves=100, num_leaves_to_search=10,
               training_sample_size=20_000)
         .score_ah(2, anisotropic_quantization_threshold=0.2).reorder(40)
         .build())
    want = s.search_batched(q)[0]
    scann_torch.save_reference_assets(s, str(tmp_path / "ref"))
    back = scann_torch.load_reference_assets(str(tmp_path / "ref"))
    assert back.device.type == "cuda"
    assert np.mean(back.search_batched(q)[0] == want) >= 0.999
    s.serialize(str(tmp_path / "idx"))
    srv = scann_torch.serve(str(tmp_path / "idx"), host="127.0.0.1",
                            port=0, block=False)
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        conn.request("POST", "/search_batched", body=q.tobytes(),
                     headers={"Content-Type": "application/octet-stream"})
        out = json.loads(conn.getresponse().read())
        assert np.mean(np.asarray(out["indices"]) == want) >= 0.999
        conn.request("POST", "/search",
                     body=json.dumps({"query": q[0].tolist()}),
                     headers={"Content-Type": "application/json"})
        out = json.loads(conn.getresponse().read())
        assert np.mean(np.asarray(out["indices"][0]) == want[0]) >= 0.9
    finally:
        srv.stop()
