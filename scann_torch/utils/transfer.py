"""Host-to-device transfers (port of scann_tpu/utils/transfer.py's API).

The JAX package uploads in bounded slices to work around a remote device
link; a CUDA card is attached locally, so ``to_device`` is one copy, from
pinned memory when the target is a CUDA device (the copy then runs
without a staging bounce).  ``default_layout`` has nothing to do: torch
tensors keep the row-major layout they were made with.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(x, dtype=torch.float32, device="cuda"):
    """``x`` (a numpy array, a sequence or a tensor) as a contiguous
    ``dtype`` tensor on ``device``.  A tensor already there with that
    dtype passes through without a copy."""
    dev = torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).contiguous()
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def default_layout(x):
    """Identity: torch tensors are row-major already (the JAX package
    re-lays arrays that a compiled program emitted transposed)."""
    return x
