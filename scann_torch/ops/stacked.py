"""Stacked (additive) quantization (port of scann_tpu/ops/stacked.py).

M full-width codebooks are summed, x_hat = sum_m C_m[code_m], instead of
product quantization's disjoint blocks.  Training is the greedy
stage-wise pass only, as in the JAX package: each stage fits k-means++ to
the residual the previous stages leave.  Codes share tree-AH's (n, M)
uint8 layout and its reconstruct mode; the dot-product LUTs are exact for
additive codes (q . x_hat = sum_m q . C_m[code_m]), squared-L2 LUTs are
not (the ||x_hat||^2 cross terms couple the stages), so tree-AH refuses
stacked LUT modes under squared L2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scann_torch.ops import kmeans as kmeans_ops


class StackedModel(NamedTuple):
    codebooks: torch.Tensor  # (num_stages, centers_per_stage, dims)
    dims: int

    @property
    def num_stages(self) -> int:
        return self.codebooks.shape[0]

    @property
    def centers_per_stage(self) -> int:
        return self.codebooks.shape[1]


def train_stacked(generator, sample, num_stages: int,
                  centers_per_stage: int = 16,
                  iterations: int = 10) -> StackedModel:
    """Stage-wise greedy training, every draw from ``generator`` in stage
    order."""
    residual = sample.float()
    books = []
    for _ in range(num_stages):
        res = kmeans_ops.kmeans(generator, residual, centers_per_stage,
                                iterations=iterations, init="kmeans++")
        books.append(res.centers)
        residual = residual - res.centers[res.assignments.long()]
    return StackedModel(codebooks=torch.stack(books),
                        dims=sample.shape[1])


def encode_stacked(vectors, model: StackedModel):
    """Greedy per-stage nearest-center encoding -> (n, num_stages)
    uint8."""
    residual = vectors.float()
    codes = []
    for m in range(model.num_stages):
        cb = model.codebooks[m]
        a, _ = kmeans_ops.assign(residual, cb)
        codes.append(a)
        residual = residual - cb[a.long()]
    return torch.stack(codes, dim=1).to(torch.uint8)


def reconstruct_stacked(codes, model: StackedModel):
    """x_hat = sum_m C_m[code_m], summed in stage order."""
    out = torch.zeros((codes.shape[0], model.dims), dtype=torch.float32,
                      device=codes.device)
    for m in range(model.num_stages):
        out = out + model.codebooks[m][codes[:, m].long()]
    return out


def build_stacked_luts(queries, model: StackedModel):
    """Dot-product LUTs: lut[q, m, j] = q . C_m[j]."""
    return torch.einsum("qd,mjd->qmj", queries.float(), model.codebooks)
