"""Profiling helpers (port of scann_tpu/utils/profiling.py).

``trace`` records a ``torch.profiler`` trace of a block (host and, where
the block runs on CUDA, device activity) and writes it to ``log_dir`` as
a Chrome trace (open it in Perfetto or chrome://tracing); ``log_phase``
logs a phase's wall-clock seconds into the ``scann_torch`` logger.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

logger = logging.getLogger("scann_torch")

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace a block with torch.profiler::

        with scann_torch.utils.profiling.trace("/tmp/trace") as prof:
            searcher.search_batched(queries)
        prof.key_averages()

    Yields the profiler; on exit the device is synchronized and the trace
    written to ``log_dir``/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def log_phase(name: str):
    """Wall-clock a phase into the scann_torch logger."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.info("%s took %.2fs", name, time.perf_counter() - t0)
