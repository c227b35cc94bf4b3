"""LUT16 scoring of a code chunk against every query's LUT (the dense
masked scan of tree-AH).

Port of scann_tpu/ops/lut16.py: ``sum_b lut[q, b, code[s, b]]`` as a
one-hot product, ``scores[q, s] = lut[q] . onehot(codes[s])``.  The JAX
package runs it as an int8 x int8 product with int32 accumulation; torch
has no general int8 matmul on CUDA, so the operands go through float32:
one-hot and int8 values are exact, and the sums stay below 2^24, so the
float32 product gives the same integers (TF32 must stay off).
"""

from __future__ import annotations

import torch

from scann_torch.ops import ah as ah_ops


def one_hot_codes(codes, clusters_per_block: int, dtype=torch.float32):
    """(m, B) int codes -> (m, B * J) one-hot."""
    j = torch.arange(clusters_per_block, dtype=torch.int32,
                     device=codes.device)
    oh = (codes[..., None].to(torch.int32) == j).to(dtype)
    return oh.reshape(codes.shape[0], -1)


def lut_matrix(luts: ah_ops.LookupTables):
    """(q, B * J) f32 operand of the one-hot product: the int8 entries, or
    the float entries rounded to bf16 (float lookup)."""
    if luts.int8 is not None:
        return luts.int8.reshape(luts.int8.shape[0], -1).float()
    return luts.raw.reshape(luts.raw.shape[0], -1).to(torch.bfloat16).float()


def score_one_hot(one_hot, lut_flat, inv_multiplier=None):
    """(m, B*J) one-hot x (q, B*J) LUT -> (q, m) f32; int8 LUTs (exact
    integer sums) are dequantized with the per-query inv_multiplier."""
    accum = lut_flat @ one_hot.T
    if inv_multiplier is None:
        return accum
    return accum * inv_multiplier[:, None]


def score_codes_chunk(codes_chunk, luts: ah_ops.LookupTables,
                      clusters_per_block: int):
    """codes_chunk: (m, B) uint8; returns (q, m) f32 similarities without
    the per-query ``base`` constant (callers add it once)."""
    return score_one_hot(
        one_hot_codes(codes_chunk, clusters_per_block), lut_matrix(luts),
        luts.inv_multiplier if luts.int8 is not None else None)
