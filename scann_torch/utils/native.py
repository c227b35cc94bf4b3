"""Host helpers of the tree-AH layout (port of the numpy paths of
scann_tpu/utils/native.py; no C library is needed here)."""

from __future__ import annotations

import numpy as np


def pack4(codes: np.ndarray) -> np.ndarray:
    """(n, B) codes in [0, 16) -> (n, ceil(B/2)) uint8, two per byte
    (even block in the low nibble)."""
    codes = np.ascontiguousarray(codes).astype(np.uint8, copy=False)
    if codes.shape[1] % 2:
        codes = np.pad(codes, ((0, 0), (0, 1)))
    return (codes[:, 0::2] & 0x0F) | ((codes[:, 1::2] & 0x0F) << 4)


def unpack4(packed: np.ndarray, blocks: int) -> np.ndarray:
    """Inverse of pack4; returns (n, blocks) uint8."""
    packed = np.ascontiguousarray(packed, np.uint8)
    out = np.empty((packed.shape[0], packed.shape[1] * 2), np.uint8)
    out[:, 0::2] = packed & 0x0F
    out[:, 1::2] = packed >> 4
    return out[:, :blocks]


def sort_by_leaf(leaf: np.ndarray, num_leaves: int):
    """Stable sort by leaf: returns (order int64, per-leaf sizes int64)."""
    leaf = np.ascontiguousarray(leaf, np.int32)
    order = np.argsort(leaf, kind="stable")
    counts = np.bincount(leaf, minlength=num_leaves).astype(np.int64)
    return order, counts


def gather_rows_i8(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Rows of a byte matrix in the given order."""
    return np.ascontiguousarray(src)[np.ascontiguousarray(order, np.int64)]
