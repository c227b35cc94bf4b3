"""Builds an edited copy of a kernel library, for the breakdown tools."""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

from scann_torch import _cuda


def apply_edits(text: str, edits) -> str:
    """``text`` with every (old, new) of ``edits`` applied; each ``old``
    must occur exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variant(tmp: str, variant: str, lib: str, fn: str, edited: str,
                  edits) -> ctypes.CDLL:
    """Compiles csrc/<lib>.cu, with ``edits`` applied to csrc/<edited>,
    in a directory of its own under ``tmp``; returns the library with
    ``fn`` bound to its signature."""
    d = os.path.join(tmp, re.sub(r"\W+", "_", f"{lib}_{variant}"))
    shutil.copytree(_cuda.CSRC, d, ignore=lambda _, names: [
        n for n in names if not n.endswith((".cu", ".cuh"))])
    path = os.path.join(d, edited)
    with open(path) as h:
        text = apply_edits(h.read(), edits)
    with open(path, "w") as h:
        h.write(text)
    out = os.path.join(d, "lib.so")
    subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", out,
                    os.path.join(d, f"{lib}.cu")], check=True,
                   capture_output=True)
    so = ctypes.CDLL(out)
    getattr(so, fn).argtypes, getattr(so, fn).restype = \
        _cuda.SIGNATURES[lib][fn]
    return so
