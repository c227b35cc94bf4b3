"""Scalar (int8) and bfloat16 dataset quantization (port of
scann_tpu/ops/quantize.py).

int8 rows carry per-dimension multipliers 127 / max|x_d| (or a quantile
of |x_d|); the noise-shaped form rounds each row with the same
parallel / perpendicular cost trade-off as the JAX package's fixed-round
coordinate descent.  Plain torch on every device: no Pallas kernel of the
JAX package is involved.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def _rdiv(a: float, t):
    """a / t rounded as one true division: torch evaluates a scalar over a
    tensor as a reciprocal times the scalar, which rounds differently from
    the JAX package's division."""
    return torch.full_like(t, a) / t


class ScalarQuantizedData(NamedTuple):
    """int8 database + per-dimension multipliers (+ squared norms of the
    dequantized rows)."""
    data: torch.Tensor                 # (n, d) int8
    inverse_multipliers: torch.Tensor  # (d,) f32
    sq_norms: torch.Tensor             # (n,) f32


def compute_multipliers(dataset, quantile: float = 1.0):
    """Per-dimension multipliers 127 / max|x_d| (or the ``quantile`` of
    |x_d|), the bound floored at 1e-20."""
    abs_x = dataset.float().abs()
    if quantile >= 1.0:
        bound = abs_x.amax(dim=0)
    else:
        bound = torch.quantile(abs_x, quantile, dim=0)
    return _rdiv(127.0, torch.clamp_min(bound, 1e-20))


def scalar_quantize(dataset, quantile: float = 1.0) -> ScalarQuantizedData:
    """Quantize a float dataset to int8 with per-dimension multipliers."""
    x = dataset.float()
    mult = compute_multipliers(x, quantile)
    q = torch.clamp(torch.round(x * mult[None, :]), -127, 127).to(torch.int8)
    inv = _rdiv(1.0, mult)
    deq = q.float() * inv[None, :]
    return ScalarQuantizedData(q, inv, (deq * deq).sum(-1))


def bfloat16_quantize(dataset):
    """Round-to-nearest bf16 compression."""
    return dataset.to(torch.bfloat16)


_NOISE_SHAPING_ROUNDS = 10

# Rows per step of the noise-shaping descent: rows are independent, so the
# chunked result is the single-pass one; a chunk bounds the (rows, d)
# intermediates of the descent.
_NOISE_SHAPING_CHUNK = 131_072


def scalar_quantize_noise_shaped(dataset, threshold: float,
                                 quantile: float = 1.0, originals=None
                                 ) -> ScalarQuantizedData:
    """int8 quantization with score-aware rounding: start from
    round-to-nearest, then per dimension consider moving one step toward
    reducing the parallel residual component, accepting strictly-improving
    flips of eta * d(par^2) + d(perp^2) for up to 10 rounds, dimensions
    visited in decreasing |residual| order.  Multipliers are global, so
    the row chunks give the single-pass result.

    ``originals``: optional (n, d) rows defining the direction the
    parallel error is measured against (and the norms eta(T) uses) when
    ``dataset`` holds residuals of those rows."""
    x = dataset.float()
    n, _ = x.shape
    mult = compute_multipliers(x, quantile)
    inv = _rdiv(1.0, mult)
    o = x if originals is None else originals.float()
    q = torch.cat([_noise_shape_rows(x[i:i + _NOISE_SHAPING_CHUNK],
                                     o[i:i + _NOISE_SHAPING_CHUNK], mult,
                                     inv, threshold)
                   for i in range(0, n, _NOISE_SHAPING_CHUNK)])
    deq = q.float() * inv[None, :]
    return ScalarQuantizedData(q, inv, (deq * deq).sum(-1))


def _noise_shape_rows(x, o, mult, inv, threshold: float):
    """Noise-shaping descent for one row chunk (direction rows ``o``);
    returns (rows, d) int8."""
    n, d = x.shape
    base = torch.clamp(torch.round(x * mult[None, :]), -127, 127)
    sq_norms = (o * o).sum(-1)
    eta = parallel_cost_multiplier(threshold, torch.clamp_min(sq_norms,
                                                              1e-20), d)
    inv_norm = _rdiv(1.0, torch.clamp_min(torch.sqrt(sq_norms), 1e-20))
    r0 = base * inv[None, :] - x          # dequant - original
    # Candidate flip per dim: one step against the residual sign.
    alt = torch.clamp(base - torch.sign(r0), -127, 127)
    r_alt = alt * inv[None, :] - x
    order = torch.argsort(-r0.abs(), dim=-1, stable=True)
    # Visit order applied once, so each step reads a column.
    op = torch.gather(o, 1, order)
    r0p = torch.gather(r0, 1, order)
    rap = torch.gather(r_alt, 1, order)
    chosen = torch.zeros((n, d), dtype=torch.bool, device=x.device)
    p = (r0 * o).sum(-1) * inv_norm
    for s in range(_NOISE_SHAPING_ROUNDS * d):
        j = s % d
        cur_alt = chosen[:, j]
        r_cur = torch.where(cur_alt, rap[:, j], r0p[:, j])
        r_new = torch.where(cur_alt, r0p[:, j], rap[:, j])
        od = op[:, j]
        new_p = p - r_cur * od * inv_norm + r_new * od * inv_norm
        pnd = new_p * new_p - p * p
        rnd = r_new * r_new - r_cur * r_cur
        cost = eta * pnd + (rnd - pnd)
        flip = (pnd <= 0.0) & (cost < 0.0)
        chosen[:, j] = cur_alt ^ flip
        p = torch.where(flip, new_p, p)
    inv_order = torch.argsort(order, dim=-1)
    chosen = torch.gather(chosen, 1, inv_order)
    return torch.where(chosen, alt, base).to(torch.int8)


def parallel_cost_multiplier(threshold, squared_norms, dims):
    """eta(T) = (T^2/||x||^2) / ((1 - T^2/||x||^2) / (d - 1)): the relative
    cost of parallel against perpendicular quantization error."""
    if math.isnan(threshold):
        return torch.ones_like(squared_norms)
    parallel_cost = _rdiv(threshold * threshold, squared_norms)
    perp_cost = (1.0 - parallel_cost) / (dims - 1.0)
    return parallel_cost / perp_cost
