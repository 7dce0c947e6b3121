"""Logical plan: operators, the rewrite rules and the fusion rule.

The port's copy of the JAX package's ``data/logical.py`` (reference:
data/_internal/logical/ — logical operators, optimizers.py rewrite rules,
notably map fusion — and _internal/planner/). The plan is a chain (Union
references sibling plans); the optimizer fuses adjacent row/batch maps with
compatible compute so one task does the whole pipeline stage (the
reference's OperatorFusionRule). The exchanges (repartition, shuffle,
sort, zip, aggregate) each stand alone as a stage.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .datasource import Datasource


@dataclass
class LogicalOp:
    pass


@dataclass
class Read(LogicalOp):
    datasource: Datasource
    parallelism: int = -1


@dataclass
class InputData(LogicalOp):
    """Pre-materialized blocks (from_blocks / materialized datasets):
    numpy blocks of this process in the port, object refs in the JAX
    package; the field keeps the reference's name."""

    refs: List[Any] = field(default_factory=list)


@dataclass
class MapBatches(LogicalOp):
    fn: Any  # callable, or class for pool-worker compute
    batch_size: Optional[int] = None
    batch_format: str = "numpy"
    fn_args: Tuple = ()
    fn_kwargs: Dict[str, Any] = field(default_factory=dict)
    fn_constructor_args: Tuple = ()
    fn_constructor_kwargs: Dict[str, Any] = field(default_factory=dict)
    compute: Optional[Any] = None  # None=tasks; ActorPoolStrategy for actors
    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None  # cards a pool worker takes: 0 or 1
    concurrency: Optional[Any] = None

    @property
    def is_actor_compute(self) -> bool:
        return isinstance(self.fn, type)


@dataclass
class MapRows(LogicalOp):
    fn: Callable[[Dict[str, Any]], Dict[str, Any]]


@dataclass
class FlatMap(LogicalOp):
    fn: Callable[[Dict[str, Any]], List[Dict[str, Any]]]


@dataclass
class Filter(LogicalOp):
    fn: Callable[[Dict[str, Any]], bool]


@dataclass
class Repartition(LogicalOp):
    num_blocks: int


@dataclass
class RandomShuffle(LogicalOp):
    seed: Optional[int] = None


@dataclass
class Sort(LogicalOp):
    key: str
    descending: bool = False


@dataclass
class Limit(LogicalOp):
    n: int


@dataclass
class Union(LogicalOp):
    others: List[List[LogicalOp]] = field(default_factory=list)


@dataclass
class Zip(LogicalOp):
    other: List[LogicalOp] = field(default_factory=list)


@dataclass
class Aggregate(LogicalOp):
    key: Optional[str]
    aggs: List[Tuple[str, str, str]] = field(default_factory=list)  # (kind, col, out_name)


ROW_OPS = (MapRows, FlatMap, Filter)


# ---------------------------------------------------------------------------
# Rewrite-rule optimizer (reference: data/_internal/logical/optimizers.py —
# an ordered rule list applied to fixpoint before planning; map fusion is
# the planner-side half, fuse_plan below).


class Rule:
    """One rewrite: ops -> ops (pure; return the input to decline)."""

    def apply(self, ops: List[LogicalOp]) -> List[LogicalOp]:
        raise NotImplementedError


class MergeLimits(Rule):
    """limit(a).limit(b) == limit(min(a, b))."""

    def apply(self, ops: List[LogicalOp]) -> List[LogicalOp]:
        out: List[LogicalOp] = []
        for op in ops:
            if (isinstance(op, Limit) and out
                    and isinstance(out[-1], Limit)):
                out[-1] = Limit(n=min(out[-1].n, op.n))
            else:
                out.append(op)
        return out


class LimitPushdown(Rule):
    """Push Limit below row-count-preserving maps so upstream stages
    produce only what survives (reference LimitPushdownRule). MapRows is
    one-to-one; Filter/FlatMap/MapBatches may change the row count, so the
    limit must stay above them."""

    def apply(self, ops: List[LogicalOp]) -> List[LogicalOp]:
        out = list(ops)
        changed = True
        while changed:
            changed = False
            for i in range(1, len(out)):
                if isinstance(out[i], Limit) and isinstance(out[i - 1],
                                                            MapRows):
                    out[i - 1], out[i] = out[i], out[i - 1]
                    changed = True
        return out


class DropRedundantShuffles(Rule):
    """A repartition/shuffle immediately followed by another whole-dataset
    redistribution does dead work: sort and shuffle re-distribute anyway,
    and of consecutive repartitions only the last layout survives."""

    _REDIST = (Repartition, RandomShuffle, Sort)

    def apply(self, ops: List[LogicalOp]) -> List[LogicalOp]:
        out: List[LogicalOp] = []
        for op in ops:
            if (out and isinstance(out[-1], (Repartition, RandomShuffle))
                    and isinstance(op, self._REDIST)
                    # A shuffle feeding a plain repartition still matters
                    # (the randomization is the point); everything else
                    # makes the PREVIOUS redistribution dead.
                    and not (isinstance(out[-1], RandomShuffle)
                             and isinstance(op, Repartition))):
                out[-1] = op
            else:
                out.append(op)
        return out


DEFAULT_RULES: List[Rule] = [MergeLimits(), LimitPushdown(),
                             DropRedundantShuffles(), MergeLimits()]


def optimize(ops: List[LogicalOp],
             rules: Optional[List[Rule]] = None) -> List[LogicalOp]:
    """Apply the rule list to fixpoint (bounded: each rule only ever
    shrinks or reorders, but cap passes defensively)."""
    for _ in range(8):
        before = list(ops)
        for rule in (rules if rules is not None else DEFAULT_RULES):
            ops = rule.apply(ops)
        if ops == before:
            break
    return ops


def is_fusable_map(op: LogicalOp) -> bool:
    if isinstance(op, ROW_OPS):
        return True
    return isinstance(op, MapBatches) and not op.is_actor_compute


def fuse_plan(ops: List[LogicalOp]) -> List[List[LogicalOp]]:
    """Group the chain into stages: runs of fusable maps become one stage
    (executed by a single task per block); everything else stands alone."""
    stages: List[List[LogicalOp]] = []
    run: List[LogicalOp] = []
    for op in ops:
        if is_fusable_map(op):
            run.append(op)
        else:
            if run:
                stages.append(run)
                run = []
            stages.append([op])
    if run:
        stages.append(run)
    return stages
