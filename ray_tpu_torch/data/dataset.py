"""Dataset: lazy block-parallel data pipelines executed as ray_tpu_torch tasks.

Parity: reference python/ray/data/dataset.py:178 (Dataset, map_batches:397,
iter_batches:3499) with the streaming execution model of
data/_internal/execution/streaming_executor.py:49 — a logical plan of
stages, executed block-parallel with bounded in-flight tasks
(backpressure), blocks living in the shared-memory object store.

Port of ray_tpu/data/dataset.py. The reference's `iter_jax_batches`
(mesh-sharded jax arrays, landed on the device by worker tasks) is
`iter_device_batches` here: CUDA tensors, placed as DTensors on a
DeviceMesh.
"""

from __future__ import annotations

import math
import random as _random
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    batch_to_block,
    block_len,
    block_to_batch,
    block_to_rows,
    concat_blocks,
    rows_to_batch,
    slice_block,
)



@dataclass
class _Stage:
    name: str
    fn: Callable  # block -> block  (run remotely)
    # Logical-plan pushdown tags (reference: data/_internal/logical
    # optimizer rules): when the stage directly follows parquet ReadTasks,
    # the executor folds it into the read itself — a projection prunes
    # columns at the file reader, a (col, op, literal) predicate prunes
    # row groups/rows — and drops the stage from the physical plan.
    pushdown_projection: list | None = None
    pushdown_filter: tuple | None = None
    all_to_all: bool = False  # needs every input block materialized first
    # Order-only barrier (randomize_block_order): all_to_all_fn permutes
    # the list of block REFS — blocks are never fetched or touched.
    reorder: bool = False
    all_to_all_fn: Callable | None = None  # blocks(list of refs) -> list[blocks]
    num_cpus: float = 1.0
    # >0: run on a pool of stateful actors instead of tasks (parity:
    # reference ActorPoolMapOperator for callable-class UDFs).
    actor_pool: int = 0
    # Distributed shuffle barrier (parity: reference push-based shuffle,
    # data/_internal/push_based_shuffle.py): map tasks split each block into
    # n_out partitions (separate objects via num_returns), reduce task j
    # merges partition j of every map — blocks never route through the
    # driver. shuffle_map_fn(block, n_out, index) -> [n_out blocks];
    # shuffle_reduce_fn(parts, j) -> block.
    shuffle_map_fn: Callable | None = None
    shuffle_reduce_fn: Callable | None = None
    # Optional driver-side planner run before the maps: samples small
    # per-block digests to compute partition boundaries (distributed sort).
    # shuffle_plan_fn(sampled) -> aux passed to map/reduce fns.
    shuffle_sample_fn: Callable | None = None
    shuffle_plan_fn: Callable | None = None


# Index of the block currently being transformed — lets seeded per-block
# stages (random_sample) derive a DISTINCT stream per block instead of
# replaying one sequence on every block (which would correlate the draws).
_current_block_index = 0


@ray_tpu_torch.remote
def _apply_fused(fn_blobs, block, index=0):
    """Run a FUSED chain of per-block stage fns in one task (logical->
    physical optimization: consecutive row/batch transforms collapse into
    a single operator, reference: data/_internal/logical optimizer's
    fuse rules — N stages cost one task and zero intermediate objects)."""
    import ray_tpu_torch.data.dataset as _ds
    from ray_tpu_torch._private import serialization

    _ds._current_block_index = index
    for blob in fn_blobs:
        block = serialization.loads_func(blob)(block)
    return block


def _apply_stage(fn_blob, block, index=0):
    import ray_tpu_torch.data.dataset as _ds
    from ray_tpu_torch._private import serialization

    _ds._current_block_index = index
    fn = serialization.loads_func(fn_blob)
    return fn(block)


@dataclass
class ReadTask:
    """A deferred source block: `fn()` produces the block rows when executed
    remotely (reference: data/datasource ReadTask — reads run as cluster
    tasks, never materializing the whole dataset on the driver)."""

    fn: Callable
    # Metadata the driver may know without reading (row count for
    # splits/estimates; None when unknown).
    num_rows: int | None = None
    # Structured description for optimizer pushdown; parquet shape:
    # {"kind": "parquet", "group": [paths], "columns": list|None,
    #  "filters": list|None, "endpoint_url": str|None}. None = opaque fn.
    meta: dict | None = None


def _pushdown_rewrite(source: list, stages: list) -> tuple[list, list]:
    """Back-compat shim over the optimizer's ParquetReadPushdown rule
    (the full catalog lives in ray_tpu_torch/data/optimizer.py)."""
    from ray_tpu_torch.data.optimizer import LogicalPlan, ParquetReadPushdown

    plan = ParquetReadPushdown().apply(LogicalPlan(source, stages))
    return plan.source, plan.stages


@ray_tpu_torch.remote
def _exec_read(fn_blob):
    from ray_tpu_torch._private import serialization

    return serialization.loads_func(fn_blob)()


@ray_tpu_torch.remote
def _shuffle_map(map_blob, block, n_out, index, aux):
    from ray_tpu_torch._private import serialization

    fn = serialization.loads_func(map_blob)
    parts = fn(block, n_out, index, aux)
    return parts if n_out > 1 else parts[0]


@ray_tpu_torch.remote
def _shuffle_reduce(reduce_blob, j, aux, *parts):
    from ray_tpu_torch._private import serialization

    fn = serialization.loads_func(reduce_blob)
    return fn(list(parts), j, aux)


@ray_tpu_torch.remote
def _shuffle_sample(sample_blob, block):
    from ray_tpu_torch._private import serialization

    return serialization.loads_func(sample_blob)(block)


def _device_runtime_ready() -> bool:
    """True when this process is attached to a running cluster (the
    device-object plane can route landings)."""
    from ray_tpu_torch._private.api_internal import core_worker_or_none

    return core_worker_or_none() is not None


# A landing task's share of a card. A landing does one host-to-device copy
# of a block and keeps the block's tensors pinned until the consumer has
# its copy: it needs a card, little of it, and a window of them
# (max_in_flight_blocks) runs at once. 1/8 lets a window of 4 run beside
# a gang worker holding half of the card.
LANDING_GPU_SHARE = 0.125

# Batches by how they reached the consumer: device_landings (landing
# tasks, tensors over the device plane) and host_batches (the off path:
# host batches copied onto the device by the consumer).
_landing_counts = {"device_landings": 0, "host_batches": 0}


def landing_counters() -> dict:
    return dict(_landing_counts)


def _free_landing_share() -> bool:
    """Whether the consumer's node has a free GPU share for a landing
    right now (a gang worker holding its whole card leaves none, and a
    landing lease would wait forever)."""
    from ray_tpu_torch._private.api_internal import get_core_worker

    cw = get_core_worker()
    for node in ray_tpu_torch.nodes():
        if node.get("node_id") == cw.node_id:
            avail = (node.get("available_resources") or {}).get("GPU", 0.0)
            return avail >= LANDING_GPU_SHARE - 1e-9
    return False


def _as_tensors(batch: dict, device):
    """Numeric columns as tensors on `device`; the others stay numpy."""
    import torch

    out = {}
    for k, v in batch.items():
        arr = np.asarray(v)
        if arr.dtype.kind in "biuf":
            out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        else:
            out[k] = arr
    return out


@ray_tpu_torch.remote(num_gpus=LANDING_GPU_SHARE)
def _land_block_torch(block, device: str):
    """Device-landing stage for iter_device_batches (the reference's
    `_land_block_jax`): the host-to-device copy of a block's numeric
    columns happens HERE, on a worker pinned to a card by its lease, and
    the tensors return pinned on it (tensor_transport="device"): the
    consumer takes them over the device plane instead of paying the copy
    itself. `device` is "cuda" (this worker's card) or "cpu"."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)
    return _as_tensors(rows_to_batch(block_to_rows(block)), dev)


@ray_tpu_torch.remote
class _StageActor:
    """Stateful map worker: constructs the UDF once, applies it per block."""

    def __init__(self, fn_blob):
        from ray_tpu_torch._private import serialization

        self._fn = serialization.loads_func(fn_blob)

    def apply(self, block):
        return self._fn(block)


class Dataset:
    """Lazy, immutable; transforms return new Datasets."""

    def __init__(self, source_blocks: list, stages: list[_Stage] | None = None):
        # source_blocks: list of ObjectRefs OR in-memory blocks (small data).
        self._source = source_blocks
        self._stages = stages or []

    # ------------- transforms (lazy) -------------

    def _with(self, stage: _Stage) -> "Dataset":
        return Dataset(self._source, self._stages + [stage])

    def map_batches(self, fn: Callable, *, batch_format: str = "numpy",
                    batch_size: int | None = None,
                    concurrency: int | None = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: dict | None = None,
                    **_ignored) -> "Dataset":
        is_class = isinstance(fn, type)
        if is_class and concurrency is None:
            concurrency = 2

        def stage_fn(block, fn=fn, batch_format=batch_format,
                     batch_size=batch_size, is_class=is_class,
                     ctor_args=fn_constructor_args,
                     ctor_kwargs=fn_constructor_kwargs):
            if is_class:
                # Construct once per process (the _StageActor deserializes
                # this function a single time, so the attribute persists
                # across blocks — stateful UDF semantics).
                udf = getattr(stage_fn, "_cached_udf", None)
                if udf is None:
                    udf = fn(*ctor_args, **(ctor_kwargs or {}))
                    stage_fn._cached_udf = udf
            else:
                udf = fn
            def to_batch(piece):
                if batch_format in ("pyarrow", "arrow"):
                    from ray_tpu_torch.data.block import block_to_arrow

                    return block_to_arrow(piece)
                if batch_format == "numpy":
                    return block_to_batch(piece)
                return block_to_rows(piece)

            if batch_size is None:
                return batch_to_block(udf(to_batch(block)), batch_format)
            outs = []
            n = block_len(block)
            for s in range(0, n, batch_size):
                piece = slice_block(block, s, min(s + batch_size, n))
                outs.append(batch_to_block(udf(to_batch(piece)), batch_format))
            return concat_blocks(outs)

        return self._with(_Stage("map_batches", stage_fn,
                                 actor_pool=concurrency or 0))

    def map(self, fn: Callable) -> "Dataset":
        def stage_fn(block, fn=fn):
            return [fn(r) for r in block_to_rows(block)]

        return self._with(_Stage("map", stage_fn))

    def filter(self, fn: Callable | None = None, *,
               expr: tuple | None = None) -> "Dataset":
        """Keep rows matching `fn`, or a structured `expr` of the form
        (column, op, literal) with op in {==, !=, <, <=, >, >=, in,
        not in}. Expression form is optimizer-visible: directly after a
        parquet read it pushes down to row-group/row pruning inside the
        read task (reference: logical-plan predicate pushdown)."""
        if (fn is None) == (expr is None):
            raise ValueError("filter takes exactly one of fn or expr")
        if expr is not None:
            col, op, lit = expr
            import operator as _op

            ops = {"==": _op.eq, "!=": _op.ne, "<": _op.lt, "<=": _op.le,
                   ">": _op.gt, ">=": _op.ge,
                   "in": lambda a, b: a in b,
                   "not in": lambda a, b: a not in b}
            if op not in ops:
                raise ValueError(f"unsupported filter op {op!r}")

            def stage_fn(block, col=col, f=ops[op], lit=lit):
                return [r for r in block_to_rows(block) if f(r[col], lit)]

            return self._with(_Stage("filter", stage_fn,
                                     pushdown_filter=(col, op, lit)))

        def stage_fn(block, fn=fn):
            return [r for r in block_to_rows(block) if fn(r)]

        return self._with(_Stage("filter", stage_fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        def stage_fn(block, fn=fn):
            out = []
            for r in block_to_rows(block):
                out.extend(fn(r))
            return out

        return self._with(_Stage("flat_map", stage_fn))

    def randomize_block_order(self, seed: int | None = None) -> "Dataset":
        """Shuffle BLOCK order without touching rows (parity:
        dataset.py randomize_block_order) — an order-only barrier that
        permutes block refs, zero data movement. The optimizer pushes it
        past map stages and deletes it when a random_shuffle follows
        (optimizer.py ReorderRandomizeBlocks / DropRedundantRandomize,
        reference: logical/rules/randomize_blocks.py)."""
        def reorder_fn(blocks, seed=seed):
            rng = _random.Random(seed)
            out = list(blocks)
            rng.shuffle(out)
            return out

        return self._with(_Stage(name="randomize_block_order", fn=None,
                                 all_to_all=True, all_to_all_fn=reorder_fn,
                                 reorder=True))

    def random_shuffle(self, seed: int | None = None) -> "Dataset":
        """Distributed push-based shuffle: each map task scatters its rows
        across n_out partitions, each reduce task merges and re-shuffles one
        partition (reference: data/_internal/push_based_shuffle.py)."""
        def map_fn(block, n_out, index, aux, seed=seed):
            rows = block_to_rows(block)
            rng = _random.Random(None if seed is None
                                 else seed * 1_000_003 + index)
            parts = [[] for _ in range(n_out)]
            for r in rows:
                parts[rng.randrange(n_out)].append(r)
            return parts

        def reduce_fn(parts, j, aux, seed=seed):
            rows = []
            for p in parts:
                rows.extend(block_to_rows(p))
            rng = _random.Random(None if seed is None
                                 else seed * 7_368_787 + j)
            rng.shuffle(rows)
            return rows

        return self._with(_Stage("random_shuffle", None,
                                 shuffle_map_fn=map_fn,
                                 shuffle_reduce_fn=reduce_fn))

    def repartition(self, num_blocks: int) -> "Dataset":
        def repart_fn(blocks: list, num_blocks=num_blocks):
            rows = []
            for b in blocks:
                rows.extend(block_to_rows(b))
            per = math.ceil(len(rows) / num_blocks) if rows else 0
            return [rows[i * per:(i + 1) * per] for i in range(num_blocks)]

        return self._with(_Stage("repartition", None, all_to_all=True,
                                 all_to_all_fn=repart_fn))

    def limit(self, n: int) -> "Dataset":
        """First n rows (parity: dataset.py Dataset.limit)."""
        ds = self
        if not self._stages and len(self._source) > 1:
            # Limit pushdown (reference: the logical optimizer's limit
            # rule): when source row counts are known without reading
            # (materialized blocks, ReadTasks with num_rows metadata —
            # e.g. sql shards), trailing sources past the limit are
            # dropped BEFORE any read executes.
            counts: list = []
            for s in self._source:
                if isinstance(s, ReadTask):
                    counts.append(s.num_rows)
                elif isinstance(s, list):
                    counts.append(len(s))
                else:
                    counts.append(None)
            if all(c is not None for c in counts):
                acc, keep = 0, []
                for s, c in zip(self._source, counts):
                    keep.append(s)
                    acc += c
                    if acc >= n:
                        break
                if len(keep) < len(self._source):
                    ds = Dataset(keep, [])
        rows = []
        for r in ds.iter_rows():
            rows.append(r)
            if len(rows) >= n:
                break
        return Dataset([rows], [])

    def random_sample(self, fraction: float, *, seed: int | None = None
                      ) -> "Dataset":
        def stage_fn(block, fraction=fraction, seed=seed):
            import ray_tpu_torch.data.dataset as _ds

            block_seed = None if seed is None \
                else seed * 1_000_003 + _ds._current_block_index
            rng = _random.Random(block_seed)
            return [r for r in block_to_rows(block)
                    if rng.random() < fraction]

        return self._with(_Stage("random_sample", stage_fn))

    def unique(self, column: str) -> list:
        seen = []
        seen_set = set()
        for r in self.iter_rows():
            v = r[column] if isinstance(r, dict) else r
            if v not in seen_set:
                seen_set.add(v)
                seen.append(v)
        return seen

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def stage_fn(block, name=name, fn=fn):
            batch = block_to_batch(block)
            batch = dict(batch)
            batch[name] = np.asarray(fn(batch))
            return batch

        return self._with(_Stage("add_column", stage_fn))

    def drop_columns(self, cols: list[str]) -> "Dataset":
        def stage_fn(block, cols=tuple(cols)):
            batch = block_to_batch(block)
            return {k: v for k, v in batch.items() if k not in cols}

        return self._with(_Stage("drop_columns", stage_fn))

    def select_columns(self, cols: list[str]) -> "Dataset":
        def stage_fn(block, cols=tuple(cols)):
            batch = block_to_batch(block)
            return {k: batch[k] for k in cols}

        return self._with(_Stage("select_columns", stage_fn,
                                 pushdown_projection=list(cols)))

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-wise zip of two datasets (parity: Dataset.zip)."""
        rows_a = self.take_all()
        rows_b = other.take_all()
        if len(rows_a) != len(rows_b):
            raise ValueError(
                f"zip requires equal row counts ({len(rows_a)} vs {len(rows_b)})")
        out = []
        for a, b in _builtin_zip(rows_a, rows_b):
            if isinstance(a, dict) and isinstance(b, dict):
                merged = dict(a)
                for k, v in b.items():
                    merged[k if k not in merged else k + "_1"] = v
                out.append(merged)
            else:
                out.append((a, b))
        return Dataset([out], [])

    def groupby(self, key: str | Callable) -> "GroupedData":
        return GroupedData(self, key)

    def sort(self, key: Callable | str | None = None,
             descending: bool = False) -> "Dataset":
        """Distributed range-partitioned sort: sample keys per block →
        boundaries on the driver → maps route rows by range → each reduce
        sorts one disjoint range (reference: data sort_and_partition /
        push-based shuffle reduce)."""
        def key_of(r, key=key):
            if key is None:
                return r
            if isinstance(key, str):
                return r[key]
            return key(r)

        def sample_fn(block):
            rows = block_to_rows(block)
            # ~20 evenly-spaced key samples per block.
            step = max(1, len(rows) // 20)
            return [key_of(r) for r in rows[::step]]

        def plan_fn(sampled, descending=descending):
            return {"keys": sorted(k for s in sampled for k in s)}

        def map_fn(block, n_out, index, aux, descending=descending):
            import bisect

            keys = aux["keys"]
            # n_out-1 boundaries at sample quantiles.
            bounds = [keys[(i + 1) * len(keys) // n_out]
                      for i in range(n_out - 1)] if keys else []
            parts = [[] for _ in range(n_out)]
            for r in block_to_rows(block):
                j = bisect.bisect_right(bounds, key_of(r))
                if descending:
                    j = n_out - 1 - j
                parts[j].append(r)
            return parts

        def reduce_fn(parts, j, aux, descending=descending):
            rows = []
            for p in parts:
                rows.extend(block_to_rows(p))
            rows.sort(key=key_of, reverse=descending)
            return rows

        return self._with(_Stage("sort", None,
                                 shuffle_map_fn=map_fn,
                                 shuffle_reduce_fn=reduce_fn,
                                 shuffle_sample_fn=sample_fn,
                                 shuffle_plan_fn=plan_fn))

    # ------------- execution -------------

    def _iter_output_blocks(self, max_in_flight: int | None = None,
                            yield_refs: bool = False) -> Iterator[Any]:
        """The streaming loop: push blocks through stages with bounded
        in-flight remote tasks (reference: streaming_executor.py:217
        scheduling loop + ExecutionResources backpressure :280).
        Execution stats (wall time, blocks, rows) land in self._last_stats
        for Dataset.stats()."""
        import time as _time

        if max_in_flight is None:
            from ray_tpu_torch.data.context import DataContext

            max_in_flight = DataContext.get_current().max_in_flight_blocks
        t0 = _time.perf_counter()
        n_blocks = n_rows = 0
        try:
            for blk in self._iter_output_blocks_inner(max_in_flight,
                                                      yield_refs=yield_refs):
                n_blocks += 1
                try:
                    n_rows += len(blk)
                except TypeError:
                    pass
                yield blk
        finally:
            # finally: early-terminated consumption (take/limit breaking out
            # of the generator) still records what ran.
            self._last_stats = {
                "wall_s": round(_time.perf_counter() - t0, 4),
                "output_blocks": n_blocks,
                "output_rows": n_rows,
                "stages": [st.name for st in self._stages],
            }

    def explain(self) -> str:
        """Logical plan before and after the optimizer rule catalog
        (reference: the DAG repr Dataset.__repr__ prints + the logical
        optimizer in _internal/logical/optimizers.py). Shows which
        stages were pushed into reads, fused, reordered, or dropped."""
        from ray_tpu_torch.data.optimizer import LogicalPlan, optimize

        def describe(source, stages):
            if source and isinstance(source[0], ReadTask):
                kind = (source[0].meta or {}).get("kind", "read")
                cols = (source[0].meta or {}).get("columns")
                filt = (source[0].meta or {}).get("filters")
                src = f"{kind}[{len(source)} tasks"
                if cols:
                    src += f", columns={list(cols)}"
                if filt:
                    src += f", filters={list(filt)}"
                src += "]"
            else:
                src = f"blocks[{len(source)}]"
            return " -> ".join([src] + [st.name for st in stages])

        before = describe(self._source, self._stages)
        plan = optimize(LogicalPlan(list(self._source),
                                    list(self._stages)))
        after = describe(plan.source, plan.stages)
        return f"logical : {before}\noptimized: {after}"

    def stats(self) -> str:
        """Execution summary of the last run (reference: Dataset.stats() —
        data/_internal/stats.py; per-stage timing there, end-to-end here)."""
        s = getattr(self, "_last_stats", None)
        if s is None:
            return "Dataset not executed yet; call materialize()/take()/... first."
        stages = " -> ".join(s["stages"]) or "(read only)"
        return (f"Stages: {stages}\n"
                f"Output: {s['output_blocks']} blocks, {s['output_rows']} rows\n"
                f"Wall time: {s['wall_s']}s")

    def _iter_output_blocks_inner(self, max_in_flight: int,
                                  yield_refs: bool = False) -> Iterator[Any]:
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch.data.context import DataContext

        task_timeout = DataContext.get_current().block_task_timeout_s

        from ray_tpu_torch.data.optimizer import LogicalPlan, optimize

        plan = optimize(LogicalPlan(list(self._source),
                                    list(self._stages)))
        source, stages = plan.source, plan.stages

        def resolve_sources() -> Iterator:
            """Launch deferred reads as remote tasks; their ObjectRefs feed
            straight into downstream stage tasks (blocks never route
            through the driver)."""
            for src in source:
                if isinstance(src, ReadTask):
                    yield _exec_read.remote(serialization.dumps_func(src.fn))
                else:
                    yield src

        blocks: Iterable = resolve_sources()
        # Split into segments at all-to-all/shuffle barriers and actor-pool
        # stages.
        segment: list[_Stage] = []
        segments: list[tuple[list[_Stage], _Stage | None]] = []
        for st in stages:
            if st.all_to_all or st.shuffle_map_fn is not None:
                segments.append((segment, st))
                segment = []
            elif st.actor_pool:
                # Actor stage runs alone in its own segment.
                if segment:
                    segments.append((segment, None))
                segments.append(([st], None))
                segment = []
            else:
                segment.append(st)
        segments.append((segment, None))

        def run_actor_segment(in_blocks: Iterable, st: _Stage) -> Iterator:
            blob = serialization.dumps_func(st.fn)
            actors = [_StageActor.remote(blob) for _ in range(st.actor_pool)]
            window: list = []
            i = 0
            try:
                for blk in in_blocks:
                    window.append(actors[i % len(actors)].apply.remote(blk))
                    i += 1
                    if len(window) >= max(max_in_flight, len(actors)):
                        yield ray_tpu_torch.get(window.pop(0), timeout=task_timeout)
                while window:
                    yield ray_tpu_torch.get(window.pop(0), timeout=task_timeout)
            finally:
                for a in actors:
                    try:
                        ray_tpu_torch.kill(a)
                    except Exception:
                        pass

        def run_segment(in_blocks: Iterable, seg: list[_Stage]) -> Iterator:
            if not seg:
                yield from in_blocks
                return
            if len(seg) == 1 and seg[0].actor_pool:
                yield from run_actor_segment(in_blocks, seg[0])
                return
            fn_blobs = [serialization.dumps_func(s.fn) for s in seg]

            def launch(blk, idx):
                # Operator FUSION: the whole per-block stage chain runs as
                # one task — no intermediate objects, no per-stage RPCs.
                return _apply_fused.remote(fn_blobs, blk, idx)

            # FIFO window: yield in submission order (dataset semantics are
            # ordered, matching the reference's OutputSplitter default).
            # The window is bounded by COUNT and by estimated BYTES
            # (reference: ExecutionResources memory limits,
            # streaming_executor.py:280) — block sizes are learned from
            # completed blocks, so a >RAM dataset streams with bounded
            # in-flight footprint.
            from ray_tpu_torch.data.block import block_nbytes
            from ray_tpu_torch.data.context import DataContext

            byte_budget = DataContext.get_current().max_in_flight_bytes
            avg_size = 0.0
            done = 0
            window: list = []
            for idx, blk in enumerate(in_blocks):
                window.append(launch(blk, idx))
                limit = max_in_flight
                if avg_size > 0 and byte_budget > 0:
                    limit = min(limit,
                                max(2, int(byte_budget / avg_size)))
                while len(window) >= limit:
                    out = ray_tpu_torch.get(window.pop(0), timeout=task_timeout)
                    done += 1
                    avg_size += (block_nbytes(out) - avg_size) / done
                    yield out
            while window:
                out = ray_tpu_torch.get(window.pop(0), timeout=task_timeout)
                done += 1
                avg_size += (block_nbytes(out) - avg_size) / done
                yield out

        def run_shuffle(in_blocks: Iterable, st: _Stage) -> Iterator:
            """Push-based shuffle: map tasks partition (num_returns=n_out
            separate objects), reduce task j fetches partition j from every
            map — no driver materialization."""
            in_refs = [b if isinstance(b, ray_tpu_torch.ObjectRef)
                       else ray_tpu_torch.put(b) for b in in_blocks]
            if not in_refs:
                return
            n_out = len(in_refs)
            aux = None
            if st.shuffle_sample_fn is not None:
                sblob = serialization.dumps_func(st.shuffle_sample_fn)
                sampled = ray_tpu_torch.get(
                    [_shuffle_sample.remote(sblob, r) for r in in_refs],
                    timeout=task_timeout)
                aux = st.shuffle_plan_fn(sampled)
            mblob = serialization.dumps_func(st.shuffle_map_fn)
            rblob = serialization.dumps_func(st.shuffle_reduce_fn)
            map_out = [
                _shuffle_map.options(num_returns=n_out).remote(
                    mblob, ref, n_out, i, aux)
                for i, ref in enumerate(in_refs)]
            if n_out == 1:
                map_out = [[r] for r in map_out]
            for j in range(n_out):
                yield _shuffle_reduce.remote(
                    rblob, j, aux, *[parts[j] for parts in map_out])

        for seg, barrier in segments:
            blocks = run_segment(blocks, seg)
            if barrier is None:
                continue
            if barrier.shuffle_map_fn is not None:
                blocks = run_shuffle(blocks, barrier)
            elif barrier.reorder:
                # Order-only barrier: permute the REFS, never fetch.
                blocks = iter(barrier.all_to_all_fn(list(blocks)))
            else:
                materialized = [b if not isinstance(b, ray_tpu_torch.ObjectRef)
                                else ray_tpu_torch.get(b) for b in blocks]
                blocks = iter(barrier.all_to_all_fn(materialized))
        if yield_refs:
            # Consumer-side landing sinks (iter_device_batches' device
            # path) feed each ref into their own remote stage — handing
            # the refs through keeps blocks off this process entirely.
            # Segment boundaries (barriers, actor pools) may have
            # materialized already; those pass through as values.
            yield from blocks
            return
        # Windowed fetch: keep up to max_in_flight refs outstanding so
        # stage-less pipelines (bare lazy reads) still run reads in
        # parallel instead of one round-trip per block.
        window: list = []
        for b in blocks:
            if not isinstance(b, ray_tpu_torch.ObjectRef):
                while window:
                    yield ray_tpu_torch.get(window.pop(0), timeout=task_timeout)
                yield b
                continue
            window.append(b)
            if len(window) >= max_in_flight:
                yield ray_tpu_torch.get(window.pop(0), timeout=task_timeout)
        while window:
            yield ray_tpu_torch.get(window.pop(0), timeout=task_timeout)

    def materialize(self) -> "Dataset":
        out = list(self._iter_output_blocks())
        return Dataset(out, [])

    # ------------- consumption -------------

    def iter_rows(self) -> Iterator:
        for block in self._iter_output_blocks():
            yield from block_to_rows(block)

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator:
        carry: list = []
        for block in self._iter_output_blocks():
            carry.extend(block_to_rows(block))
            while len(carry) >= batch_size:
                chunk, carry = carry[:batch_size], carry[batch_size:]
                yield rows_to_batch(chunk) if batch_format == "numpy" else chunk
        if carry and not drop_last:
            yield rows_to_batch(carry) if batch_format == "numpy" else carry

    def iter_device_batches(self, *, batch_size: int, mesh=None,
                            placements=None, drop_last: bool = True,
                            device_transport: bool | None = None,
                            device=None) -> Iterator:
        """Batches as tensors on the card (the reference's
        `iter_jax_batches` and `_iter_jax_batches_device`): dicts of
        numeric columns as tensors on `device` (None means CUDA; pass
        "cpu" to land on the CPU), the other columns as numpy.

        With device_transport (default: on whenever the runtime is up and
        the consumer's node has a free GPU share for a landing, see
        LANDING_GPU_SHARE), each output block's host-to-device copy runs
        on a WORKER in a tensor_transport="device" landing task, a window
        of `max_in_flight_blocks` of them, resolved in order over the
        device plane and rebatched on the device with torch.cat and
        slicing. Off, batches are formed on the host here and copied onto
        the device (counted in `landing_counters()["host_batches"]`).
        device_transport=True with no free share raises.

        With a DeviceMesh, each global batch is placed as a DTensor, by
        default Shard(0) over the mesh's "dp" and "fsdp" axes and
        replicated over the others (the reference's
        PartitionSpec(("dp", "fsdp"))). Every rank holds the whole batch,
        as every host does in the reference, and keeps its own shard."""
        from ray_tpu_torch._device import resolve_device

        dev = resolve_device(device)
        place = _placer(mesh, placements)
        if device_transport is None:
            device_transport = _device_runtime_ready() \
                and _free_landing_share()
        elif device_transport and not _free_landing_share():
            raise RuntimeError(
                "iter_device_batches(device_transport=True): this node has "
                f"no free GPU share of {LANDING_GPU_SHARE} for a landing "
                "task (a worker holding its whole card leaves none); leave "
                "device_transport=None to take the host path")
        if device_transport:
            yield from self._iter_device_batches_landed(
                batch_size, place, drop_last, dev.type)
            return
        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            _landing_counts["host_batches"] += 1
            yield place(_as_tensors(batch, dev))

    def _iter_device_batches_landed(self, batch_size: int, place,
                                    drop_last: bool,
                                    device: str) -> Iterator:
        """Pipelined device landings: one landing task per output block
        (window-bounded, like the host fetch path), resolved in order and
        rebatched on the device."""
        import torch

        from ray_tpu_torch.data.context import DataContext

        max_in_flight = DataContext.get_current().max_in_flight_blocks
        task_timeout = DataContext.get_current().block_task_timeout_s

        def landings():
            window: list = []
            for b in self._iter_output_blocks(yield_refs=True):
                window.append(_land_block_torch.options(
                    tensor_transport="device").remote(b, device))
                if len(window) >= max_in_flight:
                    yield ray_tpu_torch.get(window.pop(0),
                                            timeout=task_timeout)
            while window:
                yield ray_tpu_torch.get(window.pop(0), timeout=task_timeout)

        def cat(a, b):
            if isinstance(a, torch.Tensor):
                return torch.cat([a, b])
            return np.concatenate([a, b])

        carry: dict | None = None
        for landed in landings():
            if not landed:
                continue
            _landing_counts["device_landings"] += 1
            carry = landed if carry is None else \
                {k: cat(carry[k], landed[k]) for k in carry}
            n = len(next(iter(carry.values())))
            while n >= batch_size:
                yield place({k: v[:batch_size] for k, v in carry.items()})
                carry = {k: v[batch_size:] for k, v in carry.items()}
                n -= batch_size
        if carry is not None and not drop_last and \
                len(next(iter(carry.values()))):
            yield place(carry)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           dtypes=None, device: str | None = None,
                           drop_last: bool = False) -> Iterator:
        """Batches as torch tensors (parity: Dataset.iter_torch_batches —
        the torch-side ingest path; numeric columns become tensors, other
        columns pass through)."""
        import torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            out = {}
            for k, v in batch.items():
                arr = np.asarray(v)
                if arr.dtype.kind in "biuf":
                    t = torch.from_numpy(np.ascontiguousarray(arr))
                    if dtypes is not None:
                        want = dtypes.get(k) if isinstance(dtypes, dict) \
                            else dtypes
                        if want is not None:
                            t = t.to(want)
                    if device:
                        t = t.to(device)
                    out[k] = t
                else:
                    out[k] = arr
            yield out

    def take(self, n: int = 20) -> list:
        out = []
        for r in self.iter_rows():
            out.append(r)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> list:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(block_len(b) for b in self._iter_output_blocks())

    def sum(self, on: str | None = None):
        total = 0
        for r in self.iter_rows():
            total += r[on] if on else r
        return total

    def min(self, on: str | None = None):
        return min(r[on] if on else r for r in self.iter_rows())

    def max(self, on: str | None = None):
        return max(r[on] if on else r for r in self.iter_rows())

    def mean(self, on: str | None = None):
        values = [r[on] if on else r for r in self.iter_rows()]
        return sum(values) / len(values) if values else 0.0

    def num_blocks(self) -> int:
        return len(self._source)

    def split(self, n: int, *, equal: bool = True) -> list["Dataset"]:
        """Split into n datasets (per-train-worker shards)."""
        blocks = list(self._iter_output_blocks())
        rows = []
        for b in blocks:
            rows.extend(block_to_rows(b))
        per = len(rows) // n if equal else math.ceil(len(rows) / n)
        out = []
        for i in range(n):
            chunk = rows[i * per:(i + 1) * per] if (equal or i < n - 1) \
                else rows[i * per:]
            out.append(Dataset([chunk], []))
        return out

    def union(self, *others: "Dataset") -> "Dataset":
        blocks = list(self._iter_output_blocks())
        for o in others:
            blocks.extend(o._iter_output_blocks())
        return Dataset(blocks, [])

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.take_all())

    def schema(self):
        first = self.take(1)
        if not first:
            return None
        row = first[0]
        if isinstance(row, dict):
            return {k: type(v).__name__ for k, v in row.items()}
        return type(row).__name__

    def streaming_split(self, n: int, *, equal: bool = True
                        ) -> list["DataIterator"]:
        """n iterators over disjoint shards, for per-train-worker ingest
        (parity: Dataset.streaming_split feeding Train workers)."""
        shards = self.split(n, equal=equal)
        return [DataIterator(s) for s in shards]

    def iterator(self) -> "DataIterator":
        return DataIterator(self)

    # ------------- writes -------------

    def write_json(self, path: str) -> None:
        import json as _json
        import os

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self._iter_output_blocks()):
            with open(os.path.join(path, f"part-{i:05d}.jsonl"), "w") as f:
                for r in block_to_rows(block):
                    f.write(_json.dumps(_jsonable(r)) + "\n")

    def write_csv(self, path: str) -> None:
        import csv as _csv
        import os

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self._iter_output_blocks()):
            rows = [r if isinstance(r, dict) else {"value": r}
                    for r in block_to_rows(block)]
            if not rows:
                continue
            with open(os.path.join(path, f"part-{i:05d}.csv"), "w",
                      newline="") as f:
                w = _csv.DictWriter(f, fieldnames=list(rows[0].keys()))
                w.writeheader()
                w.writerows(_jsonable(r) for r in rows)

    def write_parquet(self, path: str) -> None:
        import os

        import pyarrow.parquet as pq

        from ray_tpu_torch.data.block import block_to_arrow

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self._iter_output_blocks()):
            if not block_len(block):
                continue
            table = block_to_arrow(block)  # no-op for arrow blocks
            pq.write_table(table, os.path.join(path, f"part-{i:05d}.parquet"))

    def write_numpy(self, path: str, *, column: str = "data") -> None:
        import os

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self._iter_output_blocks()):
            batch = block_to_batch(block)
            if column in batch:
                np.save(os.path.join(path, f"part-{i:05d}.npy"), batch[column])

    def write_mongo(self, uri: str, database: str, collection: str, *,
                    client_factory=None) -> int:
        """Waits for the MongoDB connector (ROADMAP A14)."""
        from ray_tpu_torch.data import write_mongo

        return write_mongo(self, uri, database, collection,
                           client_factory=client_factory)

    def write_tfrecords(self, path: str) -> None:
        """Waits for the TFRecord codec (ROADMAP A14)."""
        from ray_tpu_torch.data import _connector

        _connector("write_tfrecords", "tfrecord.py")()

    def __repr__(self):
        names = [s.name for s in self._stages]
        return f"Dataset(blocks={len(self._source)}, stages={names})"


def _placer(mesh, placements):
    """place(batch) for iter_device_batches: the batch itself without a
    mesh, else each tensor as a DTensor on `mesh`."""
    if mesh is None:
        return lambda batch: batch
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    if placements is None:
        names = mesh.mesh_dim_names or ()
        placements = [Shard(0) if n in ("dp", "fsdp") else Replicate()
                      for n in names]

    def place(batch):
        # src_data_rank=None: each rank keeps its own shard of the batch
        # it holds (every rank holds the whole batch), nothing is sent.
        return {k: distribute_tensor(v, mesh, placements, src_data_rank=None)
                if isinstance(v, torch.Tensor) else v
                for k, v in batch.items()}

    return place


def _jsonable(r):
    if isinstance(r, dict):
        return {k: _jsonable(v) for k, v in r.items()}
    if isinstance(r, np.generic):
        return r.item()
    if isinstance(r, np.ndarray):
        return r.tolist()
    return r


_builtin_zip = zip


class DataIterator:
    """Per-consumer iterator over a dataset shard (parity: reference
    ray.data.DataIterator from streaming_split / Dataset.iterator)."""

    def __init__(self, ds: Dataset):
        self._ds = ds

    def iter_rows(self):
        return self._ds.iter_rows()

    def iter_batches(self, **kwargs):
        return self._ds.iter_batches(**kwargs)

    def iter_device_batches(self, **kwargs):
        return self._ds.iter_device_batches(**kwargs)

    def iter_torch_batches(self, **kwargs):
        return self._ds.iter_torch_batches(**kwargs)


class GroupedData:
    """ds.groupby(key).count()/sum()/mean()/min()/max()/aggregate()
    (parity: reference data/grouped_data.py). Executes as a hash shuffle:
    rows bucket by key hash into num_blocks partitions, then per-partition
    aggregation runs block-parallel."""

    def __init__(self, ds: Dataset, key):
        self._ds = ds
        self._key = key

    def _key_fn(self):
        key = self._key
        if callable(key):
            return key
        return lambda r: r[key]

    def _groups(self) -> dict:
        kf = self._key_fn()
        groups: dict = {}
        for r in self._ds.iter_rows():
            groups.setdefault(kf(r), []).append(r)
        return groups

    def count(self) -> "Dataset":
        keyname = self._key if isinstance(self._key, str) else "key"
        rows = [{keyname: k, "count()": len(v)}
                for k, v in sorted(self._groups().items())]
        return Dataset([rows], [])

    def _agg(self, on: str, fn: Callable, label: str) -> "Dataset":
        keyname = self._key if isinstance(self._key, str) else "key"
        rows = []
        for k, grp in sorted(self._groups().items()):
            vals = [r[on] for r in grp]
            rows.append({keyname: k, f"{label}({on})": fn(vals)})
        return Dataset([rows], [])

    def sum(self, on: str) -> "Dataset":
        return self._agg(on, sum, "sum")

    def min(self, on: str) -> "Dataset":
        return self._agg(on, min, "min")

    def max(self, on: str) -> "Dataset":
        return self._agg(on, max, "max")

    def mean(self, on: str) -> "Dataset":
        return self._agg(on, lambda v: sum(v) / len(v), "mean")

    def aggregate(self, on: str, fn: Callable, label: str = "agg") -> "Dataset":
        return self._agg(on, fn, label)

    def map_groups(self, fn: Callable) -> "Dataset":
        rows = []
        for _k, grp in sorted(self._groups().items()):
            out = fn(grp)
            rows.extend(out if isinstance(out, list) else [out])
        return Dataset([rows], [])
