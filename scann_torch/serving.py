"""Serving: in-process micro-batching and an HTTP front end.

Port of scann_tpu/serving.py:

  * SearchService collects concurrent single queries into one device
    batch (batch width, not host threads, fills the card), double-buffered:
    batch N+1 is enqueued on the device (``search_batched_async``) before
    batch N's results are read back;
  * SearchServer / serve() load a serialized index directory and serve
    search over HTTP.  Replication is horizontal: one server per card,
    each on the same directory.

Protocol (JSON over HTTP; binary float32 bodies accepted):

    GET  /health                -> {"status": "ok", "n_points": N, ...}
    POST /search                -> body {"query": [f32...], params...}
    POST /search_batched        -> body {"queries": [[f32...]...], params...}
      or Content-Type: application/octet-stream with raw little-endian f32
      of shape (n, dims) and params in the query string.
    response: {"indices": [[...]], "distances": [[...]]}; errors are 400
    (bad request) and 404 (unknown path) with {"error": ...}.

Device searches are serialized by one lock: the handler threads' batched
searches and the service thread's dispatches share the searcher, whose
layouts are built on first use.

CLI: ``python -m scann_torch.serving --artifacts DIR --port 8080
[--device cuda]``.
"""

from __future__ import annotations

import json
import queue
import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np

_PARAMS = ("final_num_neighbors", "pre_reorder_num_neighbors",
           "leaves_to_search")


class SearchService:
    """Micro-batching search front end for a scann_torch searcher."""

    def __init__(self, searcher, max_batch: int = 1024,
                 max_wait_ms: float = 2.0, lock=None, **search_kwargs):
        self._searcher = searcher
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1000.0
        self._search_kwargs = search_kwargs
        self._lock = lock if lock is not None else threading.Lock()
        self._queue: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # Batches dispatched and queries they held (the mean micro-batch
        # is queries / batches).
        self.batches = 0
        self.queries = 0

    # ------------------------------------------------------------ control
    def start(self):
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._queue.put(None)  # wake the loop
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------- client
    def submit(self, query) -> Future:
        """Enqueue one query; resolves to (neighbors, distances)."""
        if not self._running:
            raise RuntimeError("SearchService is not running; call start()")
        q = np.asarray(query, np.float32)
        if q.ndim != 1:
            raise ValueError("submit() takes a single 1d query")
        fut: Future = Future()
        self._queue.put((q, fut))
        return fut

    def search(self, query, timeout=None):
        """Blocking convenience wrapper around submit()."""
        return self.submit(query).result(timeout=timeout)

    # -------------------------------------------------------------- loop
    @staticmethod
    def _resolve(inflight):
        pending, futs = inflight
        try:
            idx, dist = pending.result()
            for i, fut in enumerate(futs):
                fut.set_result((idx[i], dist[i]))
        except Exception as e:  # propagate to all waiters
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)

    def _loop(self):
        # Double-buffered: batch N+1 is enqueued before batch N's results
        # are read back (on a CUDA device their copy was enqueued with
        # batch N), so the device does not idle between batches.
        dispatch = getattr(self._searcher, "search_batched_async", None)
        inflight = None
        while self._running:
            try:
                item = self._queue.get(
                    timeout=None if inflight is None else 1e-4)
            except queue.Empty:
                # Nothing new arrived while a batch is on the device.
                self._resolve(inflight)
                inflight = None
                continue
            if item is None:
                if inflight is not None:
                    self._resolve(inflight)
                    inflight = None
                continue
            batch = [item]
            # Coalesce what arrives within the wait window, up to
            # max_batch.
            try:
                while len(batch) < self._max_batch:
                    nxt = self._queue.get(timeout=self._max_wait_s)
                    if nxt is None:
                        break
                    batch.append(nxt)
            except queue.Empty:
                pass
            queries = np.stack([q for q, _ in batch])
            futs = [fut for _, fut in batch]
            try:
                with self._lock:
                    if dispatch is not None:
                        pending = dispatch(queries, **self._search_kwargs)
                    else:  # a searcher without async dispatch
                        pending = _Resolved(self._searcher.search_batched(
                            queries, **self._search_kwargs))
            except Exception as e:
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self.batches += 1
            self.queries += len(batch)
            if inflight is not None:
                self._resolve(inflight)
            inflight = (pending, futs)
        if inflight is not None:
            self._resolve(inflight)


class _Resolved:
    """PendingSearch-shaped wrapper for results already on the host."""

    def __init__(self, out):
        self._out = out

    def result(self):
        return self._out


# ----------------------------------------------------------- network layer
class SearchServer:
    """HTTP front end over a searcher.  Single queries go through the
    micro-batcher, so concurrent clients share device batches; batched
    requests go straight to search_batched."""

    def __init__(self, searcher, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 1024, max_wait_ms: float = 2.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qsl, urlparse

        self.searcher = searcher
        self._lock = threading.Lock()
        self.service = SearchService(searcher, max_batch=max_batch,
                                     max_wait_ms=max_wait_ms,
                                     lock=self._lock)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if urlparse(self.path).path != "/health":
                    return self._reply(404, {"error": "unknown path"})
                s = outer.searcher
                self._reply(200, {
                    "status": "ok", "n_points": int(s.n_points),
                    "dims": int(s.query_dims),
                    "searcher": type(s).__name__})

            def do_POST(self):
                try:
                    parsed = urlparse(self.path)
                    params = dict(parse_qsl(parsed.query))
                    n = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(n)
                    ctype = self.headers.get("Content-Type", "")
                    if "application/octet-stream" in ctype:
                        q = np.frombuffer(raw, np.float32).reshape(
                            -1, outer.searcher.query_dims).copy()
                        source = params
                    else:
                        body = json.loads(raw.decode())
                        if parsed.path == "/search":
                            q = np.asarray([body["query"]], np.float32)
                        else:
                            q = np.asarray(body["queries"], np.float32)
                        source = body
                    kwargs = {key: int(source[key]) for key in _PARAMS
                              if key in source}
                    if parsed.path == "/search":
                        idx, dist = outer.service.submit(
                            q[0]).result(timeout=30)
                        idx, dist = [idx], [dist]
                    elif parsed.path == "/search_batched":
                        with outer._lock:
                            idx, dist = outer.searcher.search_batched(
                                q, **kwargs)
                    else:
                        return self._reply(404, {"error": "unknown path"})
                    enc = [[(d if isinstance(d, str) or d is None
                             else int(d)) for d in row] for row in idx]
                    self._reply(200, {
                        "indices": enc,
                        "distances": np.asarray(dist, np.float64).tolist()})
                except Exception as e:  # surface errors to the client
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        class Server(ThreadingHTTPServer):
            # Listen backlog: socketserver's default of 5 drops the
            # connections of a burst of concurrent clients, which then
            # retry a second later.
            request_queue_size = 128

        self._httpd = Server((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self.service.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.service.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def serve(artifacts_dir: str, host: str = "0.0.0.0", port: int = 8080,
          block: bool = True, device="cuda") -> SearchServer:
    """Load a serialized index onto ``device`` and serve it over HTTP."""
    from scann_torch.utils import serialization
    searcher = serialization.load_searcher(artifacts_dir, device)
    server = SearchServer(searcher, host=host, port=port)
    server.start()
    if block:  # pragma: no cover - CLI path
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            server.stop()
    return server


def _main():  # pragma: no cover - CLI entry
    import argparse
    ap = argparse.ArgumentParser(description="scann_torch HTTP search server")
    ap.add_argument("--artifacts", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(f"serving {args.artifacts} on {args.host}:{args.port} "
          f"({args.device})")
    serve(args.artifacts, args.host, args.port, block=True,
          device=args.device)


if __name__ == "__main__":  # pragma: no cover
    _main()
