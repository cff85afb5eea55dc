"""Logical-plan optimizer: an explicit rule catalog applied to every
Dataset plan before physical execution. Port of ray_tpu/data/optimizer.py.

Parity: reference python/ray/data/_internal/logical/rules/ — the rule
catalog (operator_fusion.py, limit_pushdown.py, randomize_blocks.py,
zero_copy_map_fusion.py, _user_provided_optimizer_rules.py) driven by
the LogicalOptimizer in _internal/logical/optimizers.py. Here the
logical plan IS the (source, stages) pair the Dataset holds, so rules
are plain plan -> plan rewrites:

- ParquetReadPushdown: fold leading projections/predicates into the
  parquet ReadTasks (pyarrow prunes columns + row groups at the file).
- MergeProjections: collapse adjacent column selections into the
  narrower one.
- DropRedundantRandomize: a randomize_block_order made irrelevant by a
  later random_shuffle (or a later randomize) is deleted.
- ReorderRandomizeBlocks: bubble randomize_block_order toward the
  source past per-block map stages so it never splits a fusable map
  chain and permutes lazy refs, not materialized blocks (reference:
  randomize_blocks.py ReorderRandomizeBlocksRule).
- FuseMapStages: collapse adjacent compatible per-block map stages into
  one stage at the LOGICAL level (reference: operator_fusion.py). The
  executor additionally fuses whatever remains adjacent at runtime —
  this rule makes the fusion decision visible in Dataset.explain().

User-provided rules (reference: _user_provided_optimizer_rules.py)
append after the built-ins via register_optimizer_rule(), or replace
the whole catalog via DataContext.optimizer_rules.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass
class LogicalPlan:
    """(source blocks/ReadTasks, stage list) — the unit rules rewrite."""

    source: list
    stages: list


class Rule:
    """A logical-plan rewrite; must preserve semantics, not cost."""

    name = "rule"

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        raise NotImplementedError


def _is_plain_map(st) -> bool:
    """Per-block task-mapped stage: safe to fuse with neighbours and to
    commute with block-order changes."""
    return (not st.all_to_all and st.shuffle_map_fn is None
            and not st.actor_pool and not getattr(st, "reorder", False))


class ParquetReadPushdown(Rule):
    """Fold leading projection/predicate stages into parquet ReadTasks
    (reference: the logical optimizer's pushdown rules run before
    physical planning)."""

    name = "parquet_read_pushdown"

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        from ray_tpu_torch.data.dataset import ReadTask

        source, stages = plan.source, plan.stages
        if not source or not all(
                isinstance(s, ReadTask) and s.meta
                and s.meta.get("kind") == "parquet" for s in source):
            return plan
        metas = [dict(s.meta) for s in source]
        i = 0
        for st in stages:
            # Fold only when transparent: a projection/predicate
            # referencing a column OUTSIDE the current projection must
            # keep its stage (which raises KeyError at runtime) —
            # folding it into pyarrow would silently succeed, diverging
            # from the non-parquet path.
            current_cols = metas[0].get("columns")
            if st.pushdown_projection is not None:
                cols = st.pushdown_projection
                if current_cols is not None and \
                        not set(cols) <= set(current_cols):
                    break
                for m in metas:
                    m["columns"] = list(cols)
            elif st.pushdown_filter is not None:
                col, _op, _lit = st.pushdown_filter
                if current_cols is not None and col not in current_cols:
                    break
                for m in metas:
                    m["filters"] = (m.get("filters") or []) + \
                        [tuple(st.pushdown_filter)]
            else:
                break
            i += 1
        if i == 0:
            return plan
        import functools

        from ray_tpu_torch.data import _read_parquet_group  # late: avoid cycle

        new_source = [
            ReadTask(fn=functools.partial(
                _read_parquet_group, m["group"], m.get("columns"),
                m.get("filters"), m.get("endpoint_url")), meta=m)
            for m in metas]
        return LogicalPlan(new_source, stages[i:])


class MergeProjections(Rule):
    """Adjacent column selections collapse into the later (narrower)
    one when it only references columns the earlier kept — the runtime
    KeyError contract is unchanged because the later selection would
    fail on those columns anyway."""

    name = "merge_projections"

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        stages = list(plan.stages)
        i = 0
        while i + 1 < len(stages):
            a, b = stages[i], stages[i + 1]
            if (a.pushdown_projection is not None
                    and b.pushdown_projection is not None
                    and set(b.pushdown_projection)
                    <= set(a.pushdown_projection)):
                del stages[i]
            else:
                i += 1
        return LogicalPlan(plan.source, stages)


class DropRedundantRandomize(Rule):
    """randomize_block_order is a no-op when a later random_shuffle (a
    full row-level shuffle) or a later randomize runs anyway (reference:
    randomize_blocks.py drops the op under the same conditions)."""

    name = "drop_redundant_randomize"

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        stages = list(plan.stages)
        out = []
        for i, st in enumerate(stages):
            if getattr(st, "reorder", False) and any(
                    getattr(later, "reorder", False)
                    or later.name == "random_shuffle"
                    for later in stages[i + 1:]):
                continue
            out.append(st)
        return LogicalPlan(plan.source, out)


class ReorderRandomizeBlocks(Rule):
    """Bubble randomize_block_order toward the SOURCE past per-block map
    stages (maps apply to every block regardless of order, so the swap
    is semantics-free; reference: ReorderRandomizeBlocksRule). Two wins:
    the map chain becomes adjacent for fusion, and the reorder barrier
    lands where blocks are still lazy ObjectRefs — permuting refs is
    free, while a reorder AFTER maps would buffer every materialized
    block at the barrier."""

    name = "reorder_randomize_blocks"

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        stages = list(plan.stages)
        changed = True
        while changed:
            changed = False
            for i in range(len(stages) - 1):
                if (_is_plain_map(stages[i])
                        and getattr(stages[i + 1], "reorder", False)):
                    stages[i], stages[i + 1] = stages[i + 1], stages[i]
                    changed = True
        return LogicalPlan(plan.source, stages)


def _compose(f, g):
    def fused(block, f=f, g=g):
        return g(f(block))

    return fused


class FuseMapStages(Rule):
    """Collapse adjacent compatible per-block maps into one logical
    stage (reference: operator_fusion.py — same compute strategy, same
    resource request). The fused stage costs one task and zero
    intermediate objects per block."""

    name = "fuse_map_stages"

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        stages = list(plan.stages)
        out: list = []
        for st in stages:
            prev = out[-1] if out else None
            if (prev is not None and _is_plain_map(prev)
                    and _is_plain_map(st)
                    and prev.num_cpus == st.num_cpus):
                out[-1] = replace(
                    prev, name=f"{prev.name}->{st.name}",
                    fn=_compose(prev.fn, st.fn),
                    # Pushdown tags describe the ORIGINAL single-purpose
                    # stage; a fused body is opaque to later rules.
                    pushdown_projection=None, pushdown_filter=None)
            else:
                out.append(st)
        return LogicalPlan(plan.source, out)


def default_rules() -> list[Rule]:
    # Order matters: pushdown first (it needs the original per-stage
    # tags), then projection merging, then the randomize rewrites, then
    # fusion (which erases the tags it consumes).
    return [ParquetReadPushdown(), MergeProjections(),
            DropRedundantRandomize(), ReorderRandomizeBlocks(),
            FuseMapStages()]


_user_rules: list[Rule] = []


def register_optimizer_rule(rule: Rule) -> None:
    """Append a user rule after the built-in catalog (reference:
    _user_provided_optimizer_rules.py)."""
    _user_rules.append(rule)


def optimize(plan: LogicalPlan) -> LogicalPlan:
    """Run the catalog (DataContext.optimizer_rules overrides the
    built-ins when set) plus registered user rules."""
    from ray_tpu_torch.data.context import DataContext

    rules = DataContext.get_current().optimizer_rules
    if rules is None:
        rules = default_rules()
    for rule in list(rules) + _user_rules:
        plan = rule.apply(plan)
    return plan
