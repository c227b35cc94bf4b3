"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc into ``_build/lib<name>.so``
(a plain C interface, loaded with ctypes) the first time a kernel of it is
launched, or ahead of time through ``build_all``.  Nothing here runs at
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


def compile_command(name: str, output: str) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", output,
            os.path.join(CSRC, f"{name}.cu")]


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless an up-to-date library exists; returns
    the compiler's messages (empty when nothing was built)."""
    out = library_path(name)
    src = os.path.join(CSRC, f"{name}.cu")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
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
    """The loaded ctypes library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
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
