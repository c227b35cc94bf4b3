"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc into ``_build/lib<name>.so``
(a plain C interface, loaded with ctypes) the first time a kernel of it is
launched, or ahead of time through ``build_all``; a library is rebuilt
when its source or a header under ``csrc/`` is newer.  Nothing here runs at
import time, so the CPU-only tests import every module without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each library's entry points (every pointer and the
# stream as c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    "pruned_sq": {
        "pruned_sq_score": ([_P] * 7 + [_I] * 4 + [_F, _P], _I),
        "pruned_sq_occupancy": ([_I, _I, _P], _I),
    },
    "pruned_lut": {
        "pruned_lut_build": ([_P] * 5 + [_I] * 4 + [_F, _P], _I),
        "pruned_lut_score": ([_P] * 8 + [_I] * 4 + [_P], _I),
        "pruned_lut_occupancy": ([_I, _I, _P], _I),
    },
    "pruned_codes": {
        "pruned_codes_score": ([_P] * 8 + [_I] * 7 + [_P], _I),
        "pruned_codes_occupancy": ([_I, _I, _I, _P], _I),
    },
    "pruned_rows": {
        "pruned_rows_score": ([_P] * 6 + [_I] * 4 + [_F, _P], _I),
        "pruned_rows_occupancy": ([_I, _I, _P], _I),
    },
    "fused_scan": {
        "fused_scan_groupmax": ([_P] * 5 + [_I] * 3 + [_F, _P], _I),
        "fused_scan_occupancy": ([_P], _I),
    },
    "merge_groups": {
        "merge_groups_topk": ([_P] * 4 + [_I] * 5 + [_P], _I),
        "merge_groups_occupancy": ([_I, _P], _I),
    },
}

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def compile_command(name: str, output: str) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", output,
            source_path(name)]


def source_files(name: str) -> list:
    """csrc/<name>.cu and every header under csrc/ (any kernel may include
    any of them)."""
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith((".cuh", ".h")))
    return [source_path(name)] + headers


def is_stale(name: str) -> bool:
    """True when lib<name>.so is missing or older than its source or a
    header under csrc/."""
    out = library_path(name)
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(f) > built for f in source_files(name))


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless an up-to-date library exists; returns
    the compiler's messages (empty when nothing was built)."""
    out = library_path(name)
    src = source_path(name)
    if not is_stale(name):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(compile_command(name, tmp),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def build_all() -> dict:
    """Compile every kernel source in parallel (one nvcc each); returns
    {name: compiler messages}."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        futures = {n: pool.submit(build, n) for n in SIGNATURES}
        return {n: f.result() for n, f in futures.items()}


def library(name: str):
    """The loaded ctypes library of csrc/<name>.cu, built on first use
    (a ``register`` span of utils/profiling.py)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            from scann_torch.utils import profiling
            with profiling.phase("register"):
                build(name)
                lib = ctypes.CDLL(library_path(name))
                for fn, (args, res) in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = args
                    getattr(lib, fn).restype = res
                lib.error_string.argtypes = [_I]
                lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def error_string(lib, err: int) -> str:
    return lib.error_string(err).decode()


def occupancy(name: str, *shape: int) -> dict:
    """What the card makes of kernel <name> at one shape (the shape
    arguments of its ``<name>_occupancy`` entry point): registers a thread,
    dynamic shared memory a block, resident blocks an SM, local (spill)
    bytes a thread."""
    lib = library(name)
    info = (ctypes.c_int * 4)()
    err = getattr(lib, f"{name}_occupancy")(*shape, info)
    if err != 0:
        raise RuntimeError(f"{name}_occupancy failed: "
                           f"{error_string(lib, err)} ({err})")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "local_bytes"), info))
