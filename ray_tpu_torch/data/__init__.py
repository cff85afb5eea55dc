"""ray_tpu_torch.data: block-parallel datasets with streaming execution.
Port of ray_tpu/data/__init__.py (reference: python/ray/data/__init__.py
read APIs: range, from_items, read_*, from_pandas/numpy).

The readers that need only the standard library and numpy are copies;
those over pandas, pyarrow, PIL or Hugging Face `datasets` import them
when called and raise ImportError where they are missing. The
connectors (the reference's `mongo.py`, `s3.py`, `sql.py` and
`tfrecord.py`, and s3:// paths) wait for ROADMAP A14 and raise
NotImplementedError naming it.
"""

from __future__ import annotations

import builtins as _builtins
import glob as _glob
import math
from typing import Any, Iterable

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import DataIterator, Dataset, GroupedData


def _to_blocks(rows: list, num_blocks: int | None) -> list:
    n = num_blocks or min(DataContext.get_current().default_block_count,
                          max(1, len(rows)))
    per = math.ceil(len(rows) / n) if rows else 0
    blocks = [rows[i * per:(i + 1) * per] for i in _builtins.range(n)]
    return [b for b in blocks if b] or [[]]


def from_items(items: list, *, override_num_blocks: int | None = None) -> Dataset:
    return Dataset(_to_blocks(list(items), override_num_blocks))


def range(n: int, *, override_num_blocks: int | None = None) -> Dataset:  # noqa: A001
    return from_items(list(_builtins.range(n)),
                      override_num_blocks=override_num_blocks)


def range_tensor(n: int, *, shape: tuple = (1,),
                 override_num_blocks: int | None = None) -> Dataset:
    rows = [{"data": np.full(shape, i, dtype=np.int64)}
            for i in _builtins.range(n)]
    return from_items(rows, override_num_blocks=override_num_blocks)


def from_numpy(arr: "np.ndarray", *, column: str = "data",
               override_num_blocks: int | None = None) -> Dataset:
    rows = [{column: a} for a in arr]
    return from_items(rows, override_num_blocks=override_num_blocks)


def from_pandas(df, *, override_num_blocks: int | None = None) -> Dataset:
    rows = df.to_dict("records")
    return from_items(rows, override_num_blocks=override_num_blocks)


def _lazy_read(files: list, read_one, override_num_blocks: int | None
               ) -> Dataset:
    """Deferred ReadTasks: the reads run as cluster tasks when the dataset
    executes (reference: data/datasource read tasks; the driver never
    materializes the input).  Default: one block per file.
    override_num_blocks < len(files) groups files into that many read
    tasks; more blocks than files can't be honored without reading (row
    counts unknown), so the block count stays at len(files) — chain
    .repartition(n) to force it."""
    from ray_tpu_torch.data.dataset import ReadTask

    def read_group(group):
        out = []
        for p in group:
            out.extend(read_one(p))
        return out

    groups = [[p] for p in files]
    if override_num_blocks is not None and 0 < override_num_blocks < len(files):
        n = override_num_blocks
        per = math.ceil(len(files) / n)
        groups = [files[i * per:(i + 1) * per] for i in _builtins.range(n)]
        groups = [g for g in groups if g]
    return Dataset([ReadTask(fn=(lambda g=g: read_group(g)))
                    for g in groups])


def read_text(paths: str | list, *, override_num_blocks: int | None = None
              ) -> Dataset:
    def read_one(p):
        with _open(p) as f:
            return [{"text": line.rstrip("\n")} for line in f]

    return _lazy_read(_expand(paths), read_one, override_num_blocks)


def read_json(paths: str | list, *, lines: bool = True,
              override_num_blocks: int | None = None) -> Dataset:
    def read_one(p, lines=lines):
        import json

        with _open(p) as f:
            if lines:
                return [json.loads(ln) for ln in f if ln.strip()]
            data = json.load(f)
            return data if isinstance(data, list) else [data]

    return _lazy_read(_expand(paths), read_one, override_num_blocks)


def from_arrow(tables, *, override_num_blocks: int | None = None) -> Dataset:
    """Dataset over pyarrow Tables — one block per table (reference:
    ray.data.from_arrow; tables are the reference's native block format)."""
    if not isinstance(tables, (list, tuple)):
        tables = [tables]
    return Dataset(list(tables))


def from_huggingface(hf_dataset, *,
                     override_num_blocks: int | None = None) -> Dataset:
    """Dataset from a Hugging Face `datasets.Dataset` (reference:
    ray.data.from_huggingface). Arrow-backed HF datasets hand over
    their table directly (zero row materialization) — EXCEPT when an
    indices mapping is live (shuffle/select/filter/train_test_split
    apply lazily via _indices; .data.table would leak the unselected
    rows), where rows materialize through the HF API instead."""
    data = getattr(hf_dataset, "data", None)
    table = getattr(data, "table", None) if data is not None else None
    if table is not None and getattr(hf_dataset, "_indices", None) is None:
        import pyarrow as pa

        if isinstance(table, pa.Table):
            n = override_num_blocks
            if n and n > 1 and table.num_rows > 1:
                per = math.ceil(table.num_rows / n)
                return from_arrow([
                    table.slice(i * per, per)
                    for i in _builtins.range(n) if i * per < table.num_rows])
            return from_arrow(table)
    return from_items(list(hf_dataset),
                      override_num_blocks=override_num_blocks)


def _read_parquet_group(group, columns, filters, endpoint_url=None):
    """One parquet read task (module-level so pushdown can rebuild it with
    pruned columns/filters)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    tables = []
    for p in group:
        _no_s3(p)
        tables.append(pq.read_table(p, columns=columns, filters=filters))
    return tables[0] if len(tables) == 1 else pa.concat_tables(tables)


def read_parquet(paths: str | list, *, columns: list | None = None,
                 filters: list | None = None,
                 endpoint_url: str | None = None,
                 override_num_blocks: int | None = None) -> Dataset:
    """Arrow-native parquet read: each read task yields a pyarrow.Table
    block (reference: ray.data.read_parquet over Arrow datasets; tables
    pickle with protocol-5 buffers so they move through the shm store
    zero-copy). The ReadTasks carry structured metadata so a following
    select_columns()/filter(expr=...) pushes down into the reader
    (reference: data/_internal/logical optimizer rules). s3:// paths wait
    for ROADMAP A14."""
    import functools

    from ray_tpu_torch.data.dataset import ReadTask

    files = _expand(paths, endpoint_url=endpoint_url)
    groups = [[p] for p in files]
    if override_num_blocks is not None and 0 < override_num_blocks < len(files):
        n = override_num_blocks
        per = math.ceil(len(files) / n)
        groups = [files[i * per:(i + 1) * per] for i in _builtins.range(n)]
        groups = [g for g in groups if g]

    tasks = []
    for g in groups:
        meta = {"kind": "parquet", "group": list(g), "columns": columns,
                "filters": filters, "endpoint_url": endpoint_url}
        tasks.append(ReadTask(
            fn=functools.partial(_read_parquet_group, list(g), columns,
                                 filters, endpoint_url),
            meta=meta))
    return Dataset(tasks)


def read_csv(paths: str | list, *, override_num_blocks: int | None = None
             ) -> Dataset:
    def read_one(p):
        import csv

        with _open(p) as f:
            return [dict(r) for r in csv.DictReader(f)]

    return _lazy_read(_expand(paths), read_one, override_num_blocks)


def read_numpy(paths: str | list, *, override_num_blocks: int | None = None
               ) -> Dataset:
    def read_one(p):
        import numpy as _np

        return [{"data": a} for a in _np.load(p)]

    return _lazy_read(_expand(paths), read_one, override_num_blocks)


def read_binary_files(paths: str | list, *, include_paths: bool = False,
                      override_num_blocks: int | None = None) -> Dataset:
    """One row per file with raw bytes (reference:
    data/read_api.py read_binary_files)."""

    def read_one(p, include_paths=include_paths):
        with _open(p, "rb") as f:
            data = f.read()
        row = {"bytes": data}
        if include_paths:
            row["path"] = p
        return [row]

    return _lazy_read(_expand(paths), read_one, override_num_blocks)


def read_images(paths: str | list, *, include_paths: bool = False,
                mode: str | None = None, size: tuple | None = None,
                override_num_blocks: int | None = None) -> Dataset:
    """One row per image file with an ndarray "image" column (reference:
    data/read_api.py read_images, incl. its (height, width) `size`
    convention). mode: PIL convert target (e.g. "RGB"); a fixed size makes
    the column batch into one dense array, the shape device input pipelines
    want."""
    try:
        import PIL  # noqa: F401
    except ImportError as e:  # pragma: no cover
        raise ImportError("read_images requires pillow") from e

    def read_one(p, include_paths=include_paths, mode=mode, size=size):
        import numpy as _np
        from PIL import Image

        with Image.open(p) as f:
            img = f.convert(mode) if mode else f
            if size:
                # size is (height, width); PIL resize takes (width, height).
                img = img.resize((size[1], size[0]))
            arr = _np.asarray(img)
        row = {"image": arr}
        if include_paths:
            row["path"] = p
        return [row]

    return _lazy_read(_expand(paths), read_one, override_num_blocks)


def _expand(paths: str | list, endpoint_url: str | None = None) -> list:
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        _no_s3(p)
        matches = sorted(_glob.glob(p))
        out.extend(matches if matches else [p])
    return out


def _open(path: str, mode: str = "r", endpoint_url: str | None = None):
    """Open a local path for the row-based readers."""
    _no_s3(path)
    return open(path, mode)


CONNECTORS_ITEM = "ROADMAP A14"


def _no_s3(path: str) -> None:
    if str(path).startswith("s3://"):
        raise NotImplementedError(
            f"s3:// paths need the reference's S3 connector "
            f"(ray_tpu/data/s3.py), which comes with {CONNECTORS_ITEM}")


def _connector(name: str, module: str):
    def waiting(*args, **kwargs):
        raise NotImplementedError(
            f"ray_tpu_torch.data.{name} needs the reference's "
            f"ray_tpu/data/{module}, which comes with {CONNECTORS_ITEM}")

    waiting.__name__ = name
    return waiting


read_mongo = _connector("read_mongo", "mongo.py")
write_mongo = _connector("write_mongo", "mongo.py")
read_sql = _connector("read_sql", "sql.py")
read_webdataset = _connector("read_webdataset", "sql.py")
read_tfrecords = _connector("read_tfrecords", "tfrecord.py")

from ray_tpu_torch.data.optimizer import (  # noqa: E402
    Rule,
    register_optimizer_rule,
)

__all__ = [
    "DataContext",
    "Dataset", "DataIterator", "GroupedData", "from_items", "range",
    "range_tensor", "from_numpy", "from_pandas", "from_arrow", "read_text",
    "read_json", "read_csv", "read_numpy", "read_parquet",
    "read_binary_files", "read_images", "read_tfrecords", "from_huggingface",
    "read_sql", "read_webdataset", "read_mongo", "write_mongo",
    "Rule", "register_optimizer_rule",
]
