"""Profiling helpers (port of scann_tpu/utils/profiling.py), and the
port's host spans.

``trace`` records a ``torch.profiler`` trace of a block (host and, where
the block runs on CUDA, device activity) and writes it to ``log_dir`` as
a Chrome trace (open it in Perfetto or chrome://tracing); the program's
spans are on inside it.  ``log_phase`` logs a phase's wall-clock seconds
into the ``scann_torch`` logger, and is a span besides.

Spans (``span(name)``) mark the program's layers on the host: a
``search`` span around each ``search_batched_async`` call, inside it one
span per search stage (``tokenize``, ``plan``, ``score``, ``merge``,
``scan``, ``reorder``, ``finish``, each ending at its stage mark), a
``result`` span around ``PendingSearch.result``, and the index build:
``build``, inside it ``partition``, ``quantize`` and ``layout`` (which
holds the database's upload; a first search's lazy pruned layout is a
``layout`` span too), and ``register`` for the first import of the
custom ops and each kernel library's first load.  These set-up spans are
``phase``s, which wait for the device at their close, so that a phase's
seconds hold the device work it queued.  A ``search`` span and the
``result`` span of the same search carry one batch id: a zero-length
``scann_torch.batch.<id>`` range at the start of each.

Spans are off unless ``enable_spans(True)`` or ``trace`` turns them on;
off, a span costs one flag check.  On, a span is a profiler range named
``scann_torch.<name>`` (so a profiler trace shows it on the clock and
thread of the kernel and copy events it launched) and adds its seconds
and one count to ``span_totals()``.  The range is torch's C++
``RecordFunctionFast`` (a ``cpu_op`` event in the trace), about 1 us,
where ``torch.profiler.record_function`` (a ``user_annotation``) costs
9-12 us with or without a profiler: ten of those a batch cost 0.16-0.38
ms of dispatch on an H100's host.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time

import torch

logger = logging.getLogger("scann_torch")

TRACE_FILE = "trace.json"
PREFIX = "scann_torch."
BATCH_TAG = PREFIX + "batch."

_on = False
_totals: dict = {}           # name -> [seconds, count]
_totals_lock = threading.Lock()
_batch_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


def enable_spans(on: bool = True) -> bool:
    """Switch the program's spans on or off; returns the previous state."""
    global _on
    was, _on = _on, bool(on)
    return was


def spans_enabled() -> bool:
    return _on


def span_totals() -> dict:
    """{name: (seconds, count)} of every span closed while spans were on
    (nested spans count in their parents' seconds too)."""
    with _totals_lock:
        return {k: (v[0], v[1]) for k, v in _totals.items()}


def reset_span_totals():
    with _totals_lock:
        _totals.clear()


def batch_id():
    """A new batch id for a search and its result (None while spans are
    off)."""
    return next(_batch_ids) if _on else None


def _profiler_range(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


class _Span:
    """One timed host range; the profiler range and the totals only while
    spans are on."""

    __slots__ = ("name", "batch", "sync", "seconds", "_range", "_t0")

    def __init__(self, name: str, batch=None, sync=False):
        self.name, self.batch, self.sync = name, batch, sync
        self.seconds = 0.0
        self._range = None

    def __enter__(self):
        if _on:
            self._range = _profiler_range(PREFIX + self.name)
            self._range.__enter__()
            if self.batch is not None:
                with _profiler_range(f"{BATCH_TAG}{self.batch}"):
                    pass
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
            with _totals_lock:
                t = _totals.setdefault(self.name, [0.0, 0])
                t[0] += self.seconds
                t[1] += 1
        return False


def span(name: str, batch=None):
    """A context manager: the span ``scann_torch.<name>`` (with the batch
    id ``batch``, if given) while spans are on, else nothing."""
    return _Span(name, batch) if _on else _OFF


def phase(name: str):
    """A set-up span: ``span(name)`` that waits for the device at its
    close."""
    return _Span(name, sync=True) if _on else _OFF


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace a block with torch.profiler, the program's spans on::

        with scann_torch.utils.profiling.trace("/tmp/trace") as prof:
            searcher.search_batched(queries)
        prof.key_averages()

    Yields the profiler; on exit the device is synchronized, the spans
    go back to their state before the block and the trace is written to
    ``log_dir``/trace.json."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was = enable_spans(True)
    try:
        with profile(activities=activities) as prof:
            try:
                yield prof
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        enable_spans(was)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def log_phase(name: str):
    """Wall-clock a phase into the scann_torch logger (a span besides)."""
    s = _Span(name)
    try:
        with s:
            yield
    finally:
        logger.info("%s took %.2fs", name, s.seconds)
