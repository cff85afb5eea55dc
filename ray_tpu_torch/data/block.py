"""Blocks: the unit of data in ray_tpu_torch.data. Port of
ray_tpu/data/block.py.

Parity: reference python/ray/data/block.py — blocks are Arrow/pandas/numpy
tables living in plasma. Here a block is one of:
  - a pyarrow.Table (columnar; the reference's primary format — pickles
    with protocol-5 out-of-band buffers, so tables round-trip through the
    shm store zero-copy and parquet IO is native),
  - a dict of numpy column arrays (the device feed format: contiguous
    columns that copy onto a card without conversion),
  - a list of rows (simple format).
Blocks travel as object-store refs so the streaming executor moves
references, not data.
"""

from __future__ import annotations

import sys
from typing import Any, Iterable

import numpy as np


def _pa():
    """pyarrow, imported where an arrow block is made: the card's machine
    may lack it, and a pipeline of numpy and row blocks never needs it."""
    try:
        import pyarrow
    except ImportError as e:
        raise ImportError("pyarrow is required for arrow blocks") from e
    return pyarrow


def is_arrow(block) -> bool:
    # A block can be a pyarrow.Table only where pyarrow is loaded.
    pa = sys.modules.get("pyarrow")
    return pa is not None and isinstance(block, pa.Table)


def block_len(block) -> int:
    if is_arrow(block):
        return block.num_rows
    if isinstance(block, dict):
        if not block:
            return 0
        return len(next(iter(block.values())))
    return len(block)


def block_to_rows(block) -> list:
    if is_arrow(block):
        return block.to_pylist()
    if isinstance(block, dict):
        keys = list(block.keys())
        n = block_len(block)
        return [{k: block[k][i] for k in keys} for i in range(n)]
    return list(block)


def rows_to_batch(rows: list) -> dict:
    """rows of dicts → dict of numpy arrays; non-dict rows get 'item'."""
    if not rows:
        return {}
    if isinstance(rows[0], dict):
        keys = rows[0].keys()
        return {k: np.asarray([r[k] for r in rows]) for k in keys}
    return {"item": np.asarray(rows)}


def block_to_batch(block) -> dict:
    if is_arrow(block):
        # Columnar → numpy dict; fixed-width columns come out zero-copy
        # when the table is a single chunk. Tensor-extension columns
        # (fixed-shape ndarrays — reference: ray.data tensor extensions)
        # come back as (n, *shape) arrays.
        out = {}
        for name in block.column_names:
            col = block.column(name)
            if isinstance(col.type, _pa().FixedShapeTensorType):
                out[name] = col.combine_chunks().to_numpy_ndarray()
                continue
            try:
                out[name] = col.to_numpy(zero_copy_only=False)
            except Exception:
                out[name] = np.asarray(col.to_pylist())
        return out
    if isinstance(block, dict):
        return block
    return rows_to_batch(block)


def _column_to_arrow(arr):
    """numpy column → arrow array; multi-dim columns become fixed-shape
    tensor extension arrays (one tensor per row), which survive parquet
    round-trips with their shape."""
    pa = _pa()
    arr = np.asarray(arr)
    if arr.ndim > 1:
        return pa.FixedShapeTensorArray.from_numpy_ndarray(
            np.ascontiguousarray(arr))
    return pa.array(arr)


def block_to_arrow(block):
    pa = _pa()
    if is_arrow(block):
        return block
    if isinstance(block, dict):
        return pa.table({k: _column_to_arrow(v) for k, v in block.items()})
    rows = block_to_rows(block)
    if rows and not isinstance(rows[0], dict):
        rows = [{"item": r} for r in rows]
    if rows and isinstance(rows[0], dict):
        # Rows whose values are ndarrays of one fixed shape batch into
        # tensor columns; ragged/mixed shapes fall back to pylist.
        cols = {}
        tensorable = True
        for k in rows[0]:
            vals = [r[k] for r in rows]
            if isinstance(vals[0], np.ndarray) and all(
                    isinstance(v, np.ndarray)
                    and v.shape == vals[0].shape
                    and v.dtype == vals[0].dtype for v in vals):
                cols[k] = _column_to_arrow(np.stack(vals))
            elif isinstance(vals[0], np.ndarray):
                tensorable = False
                break
            else:
                cols[k] = pa.array(vals)
        if tensorable and cols:
            return pa.table(cols)
    return pa.Table.from_pylist(rows)


def batch_to_block(batch, batch_format: str):
    if batch_format in ("pyarrow", "arrow"):
        return batch if is_arrow(batch) else block_to_arrow(batch)
    if batch_format in ("numpy", "batch", "dict"):
        return batch
    return block_to_rows(batch)


def slice_block(block, start: int, end: int):
    if is_arrow(block):
        return block.slice(start, end - start)
    if isinstance(block, dict):
        return {k: v[start:end] for k, v in block.items()}
    return block[start:end]


def concat_blocks(blocks: list):
    blocks = [b for b in blocks if block_len(b)]
    if not blocks:
        return []
    if is_arrow(blocks[0]):
        return _pa().concat_tables(block_to_arrow(b) for b in blocks)
    if isinstance(blocks[0], dict):
        keys = blocks[0].keys()
        return {k: np.concatenate([b[k] for b in blocks]) for k in keys}
    out = []
    for b in blocks:
        out.extend(block_to_rows(b))
    return out


def block_nbytes(block) -> int:
    """Approximate in-memory size (backpressure accounting)."""
    if is_arrow(block):
        return block.nbytes
    if isinstance(block, dict):
        return sum(getattr(v, "nbytes", len(v) * 8) for v in block.values())
    return len(block) * 64  # rough row estimate
