"""The control: the reference in the program's place, one precision down.

The configurations state float32 distances (float32 reorder rows, float32
products with TF32 off).  The nearest precision below is TF32: the inputs
of each product rounded to 10 mantissa bits, the sums kept in float32.
The rounding is done here by hand, so the control reads the same on the
CPU, which has no TF32, as on the card.  It answers exactly as a searcher
does: ``search_batched_async(queries).result()`` -> (ids, distances) as
numpy arrays, best first, distances as the program reports them.  Its
answers have the right neighbours and TF32-rounded distances, which the
check must refuse.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import exact_knn


def tf32_round(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _Done:
    def __init__(self, out):
        self._out = out

    def result(self):
        return self._out


class ControlSearcher:
    """Exact top k over ``rows`` (a float32 tensor on the device), each
    product in TF32."""

    def __init__(self, rows, k: int, measure: str, block: int = 2048):
        self.rows = rows
        self.rows_t = tf32_round(rows)
        self.k, self.measure, self.block = k, measure, block
        self.sq = (rows * rows).sum(-1) if measure == "squared_l2" else None
        self.stage_hook = None

    def search_batched_async(self, queries, **_):
        q_all = torch.as_tensor(np.asarray(queries, np.float32),
                                device=self.rows.device)
        ids, dist = [], []
        with exact_knn.tf32_off():
            for i in range(0, q_all.shape[0], self.block):
                q = q_all[i:i + self.block]
                s = tf32_round(q) @ self.rows_t.T
                if self.sq is not None:
                    s = (q * q).sum(-1)[:, None] - 2.0 * s + self.sq[None, :]
                    v, j = torch.topk(s, self.k, dim=1, largest=False)
                    v = torch.clamp_min(v, 0.0)
                else:
                    v, j = torch.topk(s, self.k, dim=1)
                ids.append(j)
                dist.append(v)
        return _Done((torch.cat(ids).cpu().numpy(),
                      torch.cat(dist).cpu().numpy()))
