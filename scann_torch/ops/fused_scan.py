"""Fused score + group-max full scan (tree-AH reconstruct mode, K5).

Port of scann_tpu/ops/fused_scan.py.  The dense scoring paths bottleneck on
memory and on top-k: a (num_queries, num_slots) score matrix would go out
to device memory and be read again by the selection.  The fused scan keeps
the scores on the chip and reduces them to one (max, argmax) candidate per
group of ``SUB`` consecutive slots:

    vals[q, G] = max_{slot in G} scale * (rows[slot] . queries[q]) + bias[slot]
    idx[q, G]  = that slot (the first on ties)

``bias`` is a per-slot additive term: -||x||^2 under squared L2 (the 2 q.x
cross term comes from ``scale`` = 2; the per-query -||q||^2 is left out,
it does not change ranks), and a large negative value on padding slots so
they are never selected.  A final exact top-k over the (Q, S/SUB)
candidates runs outside.

Correctness contract: the caller stores slots in RANDOM order (the tree-AH
layout permutes slots in reconstruct mode).  Keeping the top-1 of SUB
random slots loses a true top-k candidate only when two of them share a
group: about k^2 * SUB / (2 S) expected losses, absorbed by the reorder
budget.

``fused_scan_groupmax`` is the entry point, through the custom op of the
same name (ops/library.py): on CUDA tensors it launches the hand-written
kernel csrc/fused_scan.cu (the port of the Pallas kernel of the same
name) or raises; on CPU tensors it runs ``fused_scan_groupmax_torch``, the
plain torch version.
"""

from __future__ import annotations

import numpy as np
import torch

from scann_torch.ops import pruned_scan as ps

# Kernel launches of K5, counted by its CUDA implementation in
# ops/library.py (CPU calls never count).
launches = 0

QT = 128    # queries per kernel block: the wrapper pads a batch to it
BS = 2048   # slots per kernel block: callers pad the rows to a multiple
SUB = 256   # slots per candidate group (one survivor each)
_PAD_PENALTY = -1e30
_SLOT_CHUNK = 65536   # slots per step of the plain version
_QUERY_BLOCK = 2048   # queries per step of the plain version


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def group_max_first(sim, start: int = 0):
    """(q, m) f32 scores of m consecutive slots from global slot ``start``
    (m a multiple of SUB) -> (best (q, m // SUB) f32, idx int32 global slot
    ids): each SUB-slot group's maximum and the first slot that holds it
    (torch.argmax does not promise which of several equal maxima it
    returns)."""
    g = sim.reshape(sim.shape[0], -1, SUB)
    best = g.amax(dim=-1)
    in_group = torch.arange(SUB, dtype=torch.int32, device=sim.device)
    first = torch.where(g == best[..., None], in_group, SUB).amin(-1)
    base = start + torch.arange(g.shape[1], dtype=torch.int32,
                                device=sim.device) * SUB
    return best, first + base[None, :]


def fused_scan_groupmax_torch(queries, rows, bias, *, measure_l2=False):
    """Plain torch version of the K5 kernel: the same (vals, idx) from a
    chunked f32 product (bf16 values convert exactly, so every product is
    exact and only the summation order differs from the kernel), then
    group_max_first over each chunk (ties take the first slot of the
    group)."""
    q, d = queries.shape
    s = rows.shape[0]
    scale = 2.0 if measure_l2 else 1.0
    n_groups = s // SUB
    vals = torch.empty((q, n_groups), dtype=torch.float32,
                       device=queries.device)
    idx = torch.empty((q, n_groups), dtype=torch.int32, device=queries.device)
    chunk = min(_SLOT_CHUNK, s)
    for q0 in range(0, q, _QUERY_BLOCK):
        qf = queries[q0:q0 + _QUERY_BLOCK].float()
        for s0 in range(0, s, chunk):
            sim = scale * (qf @ rows[s0:s0 + chunk].float().T) \
                + bias[s0:s0 + chunk][None, :]
            gs = slice(s0 // SUB, (s0 + chunk) // SUB)
            vals[q0:q0 + _QUERY_BLOCK, gs], idx[q0:q0 + _QUERY_BLOCK, gs] = \
                group_max_first(sim, s0)
    return vals, idx


_STAGES = 4   # ring of stages: 256-slot row + 128-query chunks of 64 dims


def smem_bytes() -> int:
    """Shared memory of one K5 block, the same at every width: the ring of
    bf16 row and query chunks, and 1 KB to align the swizzled tiles
    (csrc/fused_scan.cu)."""
    return _STAGES * (SUB + QT) * 64 * 2 + 1024


def fused_scan_groupmax(queries, rows, bias, *, measure_l2=False):
    """queries (Q, D) bf16, rows (S, D) bf16, bias (S,) f32, with S a
    multiple of BS and D of 64, the kernel's chunk (callers pad:
    pad_for_kernel, to 128 as the JAX package does).  Returns
    (vals (Q, S // SUB) f32, idx int32 global slot ids): the best slot of
    every SUB-slot group, unsorted.  Q is free: the batch is padded to the
    kernel's query tile and the padding dropped.  CPU tensors run the
    plain version; CUDA tensors launch the CUDA kernel at any D (or raise:
    there is no fallback on the GPU)."""
    q, d = queries.shape
    s, d2 = rows.shape
    if d != d2 or s % BS or d % 64 or bias.shape != (s,):
        raise ValueError(f"unsupported shapes: queries {tuple(queries.shape)}"
                         f", rows {tuple(rows.shape)}, bias "
                         f"{tuple(bias.shape)} (rows need a multiple of {BS} "
                         f"slots and of 64 dimensions)")
    ps.check_device(rows)
    from scann_torch.ops import library
    if rows.device.type == "cpu":
        return library.fused_scan_groupmax(queries, rows, bias, measure_l2)
    # The kernel takes whole query tiles: pad, then drop the padding.
    q_pad = _round_up(max(q, 1), QT)
    if q_pad != q:
        queries = torch.nn.functional.pad(queries, (0, 0, 0, q_pad - q))
    vals, idx = library.fused_scan_groupmax(queries, rows, bias, measure_l2)
    return vals[:q], idx[:q]


def build_bias(valid: np.ndarray, sq_norms=None) -> np.ndarray:
    """Per-slot additive bias: -||x||^2 under L2, plus the padding penalty
    for invalid slots."""
    bias = np.zeros(valid.shape[0], np.float32)
    if sq_norms is not None:
        bias -= np.asarray(sq_norms, np.float32)
    bias[~valid] = _PAD_PENALTY
    return bias


def pad_for_kernel(rows_np: np.ndarray):
    """Pad (S, D) to kernel-aligned shapes; returns (rows_padded, s_pad)."""
    s, d = rows_np.shape
    s_pad = _round_up(s, BS)
    d_pad = _round_up(d, 128)
    if s_pad == s and d_pad == d:
        return rows_np, s_pad
    out = np.zeros((s_pad, d_pad), rows_np.dtype)
    out[:s, :d] = rows_np
    return out, s_pad
