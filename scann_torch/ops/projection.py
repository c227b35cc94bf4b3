"""Input projections: truncate, random orthogonal, PCA and eigenvalue-OPQ
(port of scann_tpu/ops/projection.py).

The projection applies to partitioning and AH scoring; exact reordering
still runs against the original vectors (models/base.py).  PCA draws the
same numpy sample as the JAX package (``default_rng(seed).permutation``)
and eigendecomposes its float32 covariance with ``torch.linalg.eigh``;
eigenvectors agree with the JAX package's only up to sign (and, within
near-degenerate eigenspaces, up to a rotation), so a port-trained PCA is
not bit-equal to a JAX-trained one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from scann_torch import config as cfg


class Projector(NamedTuple):
    # (d, m) projection matrix, or None for truncation.
    matrix: Optional[torch.Tensor]
    out_dims: int

    def project(self, x):
        """(..., d) -> (..., out_dims) float32."""
        if self.matrix is None:
            return x[..., :self.out_dims].float()
        return x.float() @ self.matrix.to(x.device)


def opq_order(evals: np.ndarray, d: int, num_blocks: int) -> np.ndarray:
    """Eigen-directions grouped into ``num_blocks`` equal-capacity blocks:
    each eigenvalue, largest first, goes to the currently lightest block
    with room.  Returns the column order (block after block)."""
    cap = -(-d // num_blocks)
    totals = np.zeros(num_blocks)
    fill = [[] for _ in range(num_blocks)]
    for i in np.argsort(-evals):
        open_blocks = [b for b in range(num_blocks) if len(fill[b]) < cap]
        b = min(open_blocks, key=lambda bb: totals[bb])
        fill[b].append(i)
        totals[b] += evals[i]
    return np.concatenate([np.asarray(f, np.int64) for f in fill])


def pca_dims(evals: np.ndarray, proj: cfg.ProjectionConfig) -> int:
    """Output width of PCA: ``reduction_dim``, else the smallest prefix
    explaining ``pca_significance_threshold`` of the variance, less the
    trailing directions under ``pca_truncation_threshold`` x the mean kept
    eigenvalue."""
    d = evals.shape[0]
    if proj.reduction_dim is not None:
        return int(proj.reduction_dim)
    total = evals.sum()
    cum = np.cumsum(evals) / max(total, 1e-30)
    m = int(np.searchsorted(cum, proj.pca_significance_threshold or 0.8)
            + 1)
    m = min(m, d)
    kept = evals[:m]
    thresh = (proj.pca_truncation_threshold or 0.0) * kept.mean()
    while m > 1 and evals[m - 1] < thresh:
        m -= 1
    return m


def pca_eigen(database: np.ndarray, sample_size: int, seed: int,
              device=None):
    """Eigenvalues (descending, clipped at 0, numpy) and eigenvectors
    (columns, numpy) of the float32 covariance of a row sample."""
    rng = np.random.default_rng(seed)
    n = database.shape[0]
    idx = (rng.permutation(n)[:sample_size] if n > sample_size
           else np.arange(n))
    x = torch.as_tensor(np.asarray(database[idx], np.float32),
                        device=device)
    xc = x - x.mean(0)
    cov = (xc.T @ xc) / x.shape[0]
    evals, evecs = torch.linalg.eigh(cov)     # ascending
    evals = np.maximum(evals.flip(0).cpu().numpy(), 0.0)
    return evals, evecs.flip(1).cpu().numpy()


def train_projection(database: np.ndarray, proj: cfg.ProjectionConfig,
                     sample_size: int = 100_000, seed: int = 42,
                     device=None) -> Projector:
    """Train the configured projection on ``database`` ((n, d) numpy);
    the matrix lives on ``device``."""
    d = database.shape[1]
    if proj.projection_type == "truncate":
        if proj.reduction_dim is None or proj.reduction_dim >= d:
            raise ValueError("truncate requires reduction_dim < dims")
        return Projector(matrix=None, out_dims=int(proj.reduction_dim))
    if proj.projection_type == "random_orthogonal":
        # QR of a Gaussian matrix, optionally cut to reduction_dim columns.
        rng = np.random.default_rng(seed)
        g = rng.standard_normal((d, d)).astype(np.float32)
        q_mat, _ = np.linalg.qr(g)
        m = int(proj.reduction_dim) if proj.reduction_dim else d
        return Projector(matrix=torch.as_tensor(
            np.ascontiguousarray(q_mat[:, :m]), device=device), out_dims=m)
    if proj.projection_type not in ("pca", "eigenvalue_opq"):
        raise ValueError(f"unknown projection type {proj.projection_type}")
    evals, evecs = pca_eigen(database, sample_size, seed, device)
    if proj.projection_type == "eigenvalue_opq":
        num_blocks = proj.opq_num_blocks or max(1, d // 2)
        order = opq_order(evals, d, num_blocks)
        return Projector(matrix=torch.as_tensor(
            np.ascontiguousarray(evecs[:, order]), device=device),
            out_dims=d)
    m = pca_dims(evals, proj)
    return Projector(matrix=torch.as_tensor(
        np.ascontiguousarray(evecs[:, :m]), device=device), out_dims=m)
