"""Serving (ROADMAP item 18) against scann_tpu: over one JAX-built index
loaded in both packages, the port's SearchService returns what the JAX
service returns, and its HTTP server (JSON, octet-stream bodies,
/health, 400 and 404) answers as the JAX server does, on the CPU."""

import http.client
import json
import threading

import numpy as np
import pytest

import scann_torch
import scann_tpu
from scann_torch import serving as tserving
from scann_tpu import serving as jserving
import torch_threads  # noqa: F401  (torch threads per xdist worker)


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    rng = np.random.default_rng(0)
    db = rng.standard_normal((3000, 24)).astype(np.float32)
    q = rng.standard_normal((40, 24)).astype(np.float32)
    s = (scann_tpu.builder(db, 5, "dot_product")
         .tree(num_leaves=10, num_leaves_to_search=4,
               training_sample_size=3000)
         .score_ah(2).reorder(20).build())
    d = str(tmp_path_factory.mktemp("served") / "idx")
    s.serialize(d)
    return d, q, s


def test_service_matches_jax_service(index):
    d, q, js = index
    ts = scann_torch.load_searcher(d, device="cpu")
    want = [None] * len(q)
    with jserving.SearchService(js, max_batch=16, max_wait_ms=20.0) as svc:
        futs = [svc.submit(q[i]) for i in range(len(q))]
        want = [f.result(timeout=120) for f in futs]
    with tserving.SearchService(ts, max_batch=16, max_wait_ms=20.0) as svc:
        futs = [svc.submit(q[i]) for i in range(len(q))]
        got = [f.result(timeout=120) for f in futs]
        assert svc.queries == len(q) and 1 <= svc.batches <= len(q)
    for (gi, gd), (wi, wd) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-5)


def test_service_errors_match_jax():
    db = np.random.default_rng(0).standard_normal((200, 8)).astype(
        np.float32)
    for pkg, svc_mod, kw in ((scann_tpu, jserving, {}),
                             (scann_torch, tserving, {"device": "cpu"})):
        s = pkg.builder(db, 3, "dot_product", **kw).score_brute_force(
        ).build()
        svc = svc_mod.SearchService(s)
        with pytest.raises(RuntimeError):
            svc.submit(db[0])               # not started
        svc.start()
        with pytest.raises(ValueError):
            svc.submit(db[:2])              # 2d input
        with pytest.raises(ValueError):
            svc.submit(np.zeros(4, np.float32)).result(timeout=60)
        svc.stop()


def _ask(server, method, path, body=None, ctype="application/json"):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    headers = {} if body is None else {"Content-Type": ctype}
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


_REQUESTS = [
    ("GET", "/health", None, "application/json"),
    ("GET", "/nowhere", None, "application/json"),
    ("POST", "/nowhere", b"{}", "application/json"),
    ("POST", "/search_batched", "queries", "application/json"),
    ("POST", "/search_batched", "queries_k3", "application/json"),
    ("POST", "/search_batched?final_num_neighbors=3", "raw",
     "application/octet-stream"),
    ("POST", "/search", "query", "application/json"),
    ("POST", "/search_batched", "bad_dims", "application/json"),
    ("POST", "/search_batched", b"{not json", "application/json"),
]


def _body(kind, q):
    if kind == "queries":
        return json.dumps({"queries": q.tolist()})
    if kind == "queries_k3":
        return json.dumps({"queries": q[:5].tolist(),
                           "final_num_neighbors": 3,
                           "leaves_to_search": 10})
    if kind == "raw":
        return q.tobytes()
    if kind == "query":
        return json.dumps({"query": q[0].tolist()})
    if kind == "bad_dims":
        return json.dumps({"queries": [[1.0, 2.0]]})
    return kind


def test_http_servers_answer_alike(index):
    d, q, _ = index
    jsrv = scann_tpu.serve(d, host="127.0.0.1", port=0, block=False)
    tsrv = scann_torch.serve(d, host="127.0.0.1", port=0, block=False,
                             device="cpu")
    try:
        assert tsrv.searcher.device.type == "cpu"
        for method, path, kind, ctype in _REQUESTS:
            body = None if kind is None else _body(kind, q)
            jst, jout = _ask(jsrv, method, path, body, ctype)
            tst, tout = _ask(tsrv, method, path, body, ctype)
            assert tst == jst, (path, kind, tout, jout)
            if jst != 200:
                assert "error" in tout
                if jst == 404:
                    assert tout == jout
                continue
            if path == "/health":
                assert tout == jout
                continue
            np.testing.assert_array_equal(np.asarray(tout["indices"]),
                                          np.asarray(jout["indices"]))
            np.testing.assert_allclose(np.asarray(tout["distances"]),
                                       np.asarray(jout["distances"]),
                                       rtol=1e-5)
    finally:
        jsrv.stop()
        tsrv.stop()


def test_concurrent_single_queries_equal_batched(index):
    """Single queries from many client threads share micro-batches and
    answer exactly what one batched search answers."""
    d, q, _ = index
    srv = scann_torch.serve(d, host="127.0.0.1", port=0, block=False,
                            device="cpu")
    try:
        want_idx, want_dist = srv.searcher.search_batched(q)
        got = [None] * len(q)

        def client(lo):
            for i in range(lo, len(q), 8):
                got[i] = _ask(srv, "POST", "/search",
                              json.dumps({"query": q[i].tolist()}))[1]

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        np.testing.assert_array_equal(
            np.asarray([g["indices"][0] for g in got]), want_idx)
        np.testing.assert_allclose(
            np.asarray([g["distances"][0] for g in got]), want_dist,
            rtol=1e-6)
        assert srv.service.queries == len(q)
    finally:
        srv.stop()
