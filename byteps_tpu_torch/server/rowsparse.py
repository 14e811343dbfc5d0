"""Row-sparse push_pull through the PS path (the port's copy of
``byteps_tpu/server/rowsparse.py``, the same wire format byte for byte).

The reference reserved this request type (``RequestType::kRowSparsePushPull``,
common.h:267-271) but shipped no handler. Embedding-style gradients, where
only a few rows of a ``[num_rows, cols]`` table are nonzero a step, push
only the touched (row index, row) pairs; the server scatters them into a
dense table and the summation engine merges it across workers like a dense
push (duplicate indices within one push are summed, the scatter-add
contract, in index order: ``np.add.at``); pulls return the dense merged
table. A push costs ~touched_rows·cols instead of num_rows·cols on the wire.

Wire format (little-endian): ``n:u32 | idx:i32[n] | rows:dtype[n·cols]``.
The transport frame's ``nbytes`` field carries the DENSE table's byte size,
so the server derives num_rows without per-key metadata.
"""

from __future__ import annotations

import struct

import numpy as np


def pack_rows(idx, rows) -> bytes:
    """(int row indices [n], row values [n, cols]) → wire bytes."""
    idx = np.ascontiguousarray(np.asarray(idx, dtype=np.int32).reshape(-1))
    rows = np.ascontiguousarray(np.asarray(rows))
    if rows.ndim != 2 or rows.shape[0] != idx.shape[0]:
        raise ValueError(f"rows must be [n, cols] with n == len(idx); got "
                         f"idx {idx.shape}, rows {rows.shape}")
    return struct.pack("<I", idx.shape[0]) + idx.tobytes() + rows.tobytes()


def unpack_rows(buf, dtype: str):
    """Wire bytes → (idx [n], rows [n, cols]), cols derived from the size.
    ``buf`` may be any buffer (a memoryview too); no copy is made."""
    (n,) = struct.unpack_from("<I", buf, 0)
    idx = np.frombuffer(buf, np.int32, count=n, offset=4)
    rows = np.frombuffer(buf, np.dtype(dtype), offset=4 + 4 * n)
    if n:
        if rows.size % n:
            raise ValueError("row payload not divisible by index count")
        rows = rows.reshape(n, rows.size // n)
    else:
        rows = rows.reshape(0, 0)
    return idx, rows


def scatter_dense(idx, rows, num_rows: int, dtype: str) -> np.ndarray:
    """Scatter-ADD rows into a dense [num_rows, cols] table (duplicate
    indices sum, in index order)."""
    cols = rows.shape[1] if rows.size else 0
    dense = np.zeros((num_rows, cols), np.dtype(dtype))
    if rows.size:
        np.add.at(dense, idx, rows)
    return dense


def rowsparse_push(backend, key: int, idx, rows, dense_nbytes: int,
                   dtype=None, meta=None) -> None:
    """Expand a sparse (idx, rows) push to dense and hand it to the
    summation engine (the compressed path's expand-then-sum, server.cc:86-113).
    An EMPTY push contributes a zero table: it still joins the sync round,
    or the peers would wait on the merge for good.

    ``meta`` (a dict) pins cols per key on its first push: a later push
    with other cols (a mis-built worker) is refused rather than scattering
    rows at the wrong offsets."""
    idx = np.asarray(idx, np.int32).reshape(-1)
    rows = np.asarray(rows)
    dtype = str(rows.dtype) if dtype is None else str(np.dtype(dtype))
    itemsize = np.dtype(dtype).itemsize
    if dense_nbytes % itemsize:
        raise ValueError("table size not a multiple of the element size")
    total = dense_nbytes // itemsize
    if idx.size == 0 or rows.size == 0:
        backend.push(key, np.zeros(total, dtype))
        return
    if rows.ndim != 2 or rows.shape[0] != idx.size:
        raise ValueError(f"rows must be [n, cols] with n == len(idx); got "
                         f"idx {idx.shape}, rows {rows.shape}")
    cols = rows.shape[1]
    if meta is not None:
        prev = meta.setdefault(key, cols)
        if prev != cols:
            raise ValueError(f"key {key}: cols {cols} != established "
                             f"{prev} — workers disagree on the table")
    if total % cols:
        raise ValueError(f"cols={cols} incompatible with a "
                         f"{dense_nbytes}-byte table")
    num_rows = total // cols
    if idx.min() < 0 or idx.max() >= num_rows:
        raise ValueError(f"row index out of range [0, {num_rows})")
    backend.push(key, scatter_dense(idx, rows, num_rows, dtype)
                 .astype(dtype, copy=False).reshape(-1))
