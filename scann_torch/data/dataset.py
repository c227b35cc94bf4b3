"""Dataset containers (port of scann_tpu/data/dataset.py).

``DenseDataset`` holds an (n, d) array: int8 / uint8 rows keep their
1 B a dimension (a typed dataset), everything else is float32; rows may
carry docids and a unit-L2 normalization tag.  ``MetadataGetter`` is the
per-neighbor payload lookup a searcher attaches with ``set_metadata``.
Host-side numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

UNITL2NORM = "unitl2norm"
NONE = "none"


class DenseDataset:
    """An owning (n, d) dataset with optional docids and normalization
    tag."""

    def __init__(self, data, docids: Optional[Iterable[str]] = None,
                 normalization: str = NONE):
        data = np.asarray(data)
        # Typed rows stay typed; normalization forces float (unit rows are
        # not integral).
        if data.dtype in (np.int8, np.uint8) and normalization == NONE:
            self.data = data
        else:
            self.data = np.asarray(data, np.float32)
        if self.data.ndim != 2:
            raise ValueError("DenseDataset requires a 2d array")
        self.docids = list(docids) if docids is not None else None
        if self.docids is not None and len(self.docids) != len(self.data):
            raise ValueError("docids must match dataset size")
        self.normalization = NONE
        if normalization == UNITL2NORM:
            self.set_unit_l2_norm()

    def __len__(self):
        return self.data.shape[0]

    @property
    def dimensionality(self) -> int:
        return self.data.shape[1]

    def set_unit_l2_norm(self):
        """Normalize the rows to unit L2 norm (in place)."""
        norms = np.linalg.norm(self.data, axis=1, keepdims=True)
        self.data = self.data / np.maximum(norms, 1e-20)
        self.normalization = UNITL2NORM
        return self

    def docid_for_index(self, i: int):
        return self.docids[i] if self.docids is not None else None

    def append(self, rows, docids: Optional[Iterable[str]] = None):
        """Append rows (normalized when the dataset is), with their docids
        when the dataset carries docids."""
        rows = np.asarray(rows, self.data.dtype)
        if rows.ndim == 1:
            rows = rows[None, :]
        if self.normalization == UNITL2NORM:
            rows = rows / np.maximum(
                np.linalg.norm(rows, axis=1, keepdims=True), 1e-20)
        self.data = np.concatenate([self.data, rows], axis=0)
        if self.docids is not None:
            if docids is None:
                raise ValueError("dataset has docids; append requires them")
            self.docids.extend(docids)
        return self


class MetadataGetter:
    """Per-neighbor metadata lookup attached to a searcher; subclass and
    override get() for custom payloads."""

    def __init__(self, payloads=None):
        self._payloads = payloads

    def get(self, datapoint_index: int):
        if self._payloads is None:
            return None
        return self._payloads[datapoint_index]

    def batch_get(self, indices):
        return [self.get(int(i)) for i in np.asarray(indices).reshape(-1)]
