"""The one-device half of the pipeline layer (counterpart of
``sheeprl_tpu/parallel/pipeline.py``): the 1F1B microbatch schedule of the
world-model update, and the row chunks of the imagination heads.

On one device no weight is placed by stage: the schedule only orders the
microbatches and bounds how many activations are live, a memory lever like
``algo.remat``.  The pieces:

* :class:`PipelineSpec` and :func:`resolve_pipeline` — the ``pipeline``
  config group, validated with the JAX package's messages;
* :func:`one_f_one_b` and :func:`bubble_fraction` — the schedule's unit
  order and its idle share, the JAX functions verbatim;
* :func:`split_microbatches` / :func:`merge_microbatches` — contiguous row
  chunks along the batch axis, and back;
* :func:`pipeline_value_and_grad` — the stage chain over the microbatches in
  1F1B order under autograd: a stage boundary is a detached carry that
  requires grad, each ``B`` unit is one :func:`torch.autograd.backward` of
  its stage's outputs with the cotangent of the stage after it, and the
  parameter gradients build up in ``.grad`` in schedule order, scaled by
  ``1/M`` at the end.  A unit's graph is freed by its backward, so at most
  ``S - s`` forward activations of stage ``s`` are alive;
* :func:`chunked_rows` — a per-row function over row chunks.

The sample-invariance law holds as in JAX: a stage draws nothing, its noise
is drawn at full batch and sliced per microbatch, so a schedule changes
only the order of float sums.  The mesh half (``compose_pipeline_rules``,
``stage_batch_constraint``, ``compile_stage_pair``) waits for the layer
above one device (ROADMAP.md, queue A item 5(b)).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "PipelineSpec",
    "resolve_pipeline",
    "one_f_one_b",
    "bubble_fraction",
    "split_microbatches",
    "merge_microbatches",
    "pipeline_value_and_grad",
    "chunked_rows",
    "register_pipeline_metrics",
    "PIPELINE_ALGOS",
]

#: algorithms whose train step implements the stage split
PIPELINE_ALGOS: Tuple[str, ...] = ("dreamer_v3",)

#: the pipeline mesh axis's name in the JAX package (``fabric.mesh_shape``)
PIPELINE_AXIS = "pipeline"


@dataclass(frozen=True)
class PipelineSpec:
    """The resolved ``pipeline`` config group (``configs/pipeline/default.yaml``)."""

    stages: int = 1
    microbatches: int = 1
    axis: str = PIPELINE_AXIS
    schedule: str = "1f1b"
    #: row chunks of the imagination batch's head evaluations (:func:`chunked_rows`)
    imagination_microbatches: int = 1

    @property
    def enabled(self) -> bool:
        return self.stages > 1 or self.microbatches > 1

    @property
    def bubble_frac(self) -> float:
        return bubble_fraction(self.stages, self.microbatches)

    def check_algo(self, algo_name: str) -> None:
        if self.enabled and algo_name not in PIPELINE_ALGOS:
            raise ValueError(
                f"pipeline parallelism (pipeline.stages={self.stages}, "
                f"pipeline.microbatches={self.microbatches}) is implemented for "
                f"{PIPELINE_ALGOS}, not '{algo_name}'; set pipeline.stages=1 "
                "and pipeline.microbatches=1 (configs/pipeline/default.yaml)"
            )

    def metrics(self) -> Dict[str, float]:
        """``Pipeline/*`` metrics for the telemetry hub."""
        if not self.enabled:
            return {}
        return {
            "Pipeline/stages": float(self.stages),
            "Pipeline/microbatches": float(self.microbatches),
            "Pipeline/bubble_frac": self.bubble_frac,
        }


def resolve_pipeline(cfg: Any) -> PipelineSpec:
    """``cfg.pipeline`` → a validated :class:`PipelineSpec`; the whole config
    or the group itself; a missing group is the disabled spec."""
    group = cfg.get("pipeline") if hasattr(cfg, "get") else None
    if group is None:
        group = {}
    stages = int(group.get("stages", 1))
    microbatches = int(group.get("microbatches", 1))
    schedule = str(group.get("schedule", "1f1b"))
    imag = int(group.get("imagination_microbatches", 1))
    if stages < 1 or microbatches < 1 or imag < 1:
        raise ValueError(
            f"pipeline.stages ({stages}), pipeline.microbatches ({microbatches}) "
            f"and pipeline.imagination_microbatches ({imag}) must all be >= 1"
        )
    if schedule != "1f1b":
        raise ValueError(
            f"pipeline.schedule='{schedule}' is not supported; the only "
            "implemented schedule is '1f1b' (docs/pipeline.md)"
        )
    if stages > 1 and microbatches < stages:
        raise ValueError(
            f"pipeline.microbatches ({microbatches}) must be >= pipeline.stages "
            f"({stages}): with fewer microbatches than stages the 1F1B schedule "
            f"is all bubble (bubble_frac="
            f"{bubble_fraction(stages, max(microbatches, 1)):.2f}); raise "
            "microbatches or lower stages"
        )
    return PipelineSpec(stages=stages, microbatches=microbatches, schedule=schedule, imagination_microbatches=imag)


def bubble_fraction(stages: int, microbatches: int) -> float:
    """The idle share of the 1F1B schedule, ``(S-1)/(M+S-1)``: ``M + S - 1``
    ticks drain ``M`` microbatches through ``S`` stages."""
    s, m = int(stages), int(microbatches)
    if s <= 1:
        return 0.0
    return (s - 1) / (m + s - 1)


def one_f_one_b(stages: int, microbatches: int) -> List[Tuple[str, int, int]]:
    """The one-forward-one-backward unit order ``[(op, stage, microbatch)]``,
    ``op`` in ``{"F", "B"}``: a tick simulation of the non-interleaved 1F1B
    schedule, each stage one unit per tick, stage ``s`` ramping up to
    ``S - s`` forwards in flight, then alternating; dependencies are checked
    against the previous tick's completions."""
    S, M = int(stages), int(microbatches)
    if S < 1 or M < 1:
        raise ValueError(f"one_f_one_b: need stages >= 1 and microbatches >= 1, got ({S}, {M})")
    order: List[Tuple[str, int, int]] = []
    f_cnt = [0] * S
    b_cnt = [0] * S
    max_ticks = 4 * S * (M + S)
    for _ in range(max_ticks):
        if all(f == M for f in f_cnt) and all(b == M for b in b_cnt):
            return order
        f_snap, b_snap = list(f_cnt), list(b_cnt)
        progressed = False
        for s in range(S):
            in_flight = f_cnt[s] - b_cnt[s]
            cap = S - s
            can_f = f_cnt[s] < M and (s == 0 or f_cnt[s] < f_snap[s - 1])
            can_b = (
                b_cnt[s] < M
                and b_cnt[s] < f_snap[s]
                and (s == S - 1 or b_cnt[s] < b_snap[s + 1])
            )
            if can_b and (in_flight >= cap or f_cnt[s] == M):
                order.append(("B", s, b_cnt[s]))
                b_cnt[s] += 1
                progressed = True
            elif can_f and in_flight < cap:
                order.append(("F", s, f_cnt[s]))
                f_cnt[s] += 1
                progressed = True
            elif can_b:
                order.append(("B", s, b_cnt[s]))
                b_cnt[s] += 1
                progressed = True
        if not progressed:
            raise RuntimeError(
                f"one_f_one_b: schedule wedged at f={f_cnt} b={b_cnt} "
                f"(stages={S}, microbatches={M}) — internal scheduling bug"
            )
    raise RuntimeError(
        f"one_f_one_b: schedule did not drain within {max_ticks} ticks "
        f"(stages={S}, microbatches={M}) — internal scheduling bug"
    )


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples; dict keys in
    sorted order, as JAX's tree utilities walk them (so an error names the
    leaf JAX's would)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def split_microbatches(tree: Any, microbatches: int, axis: int = 1) -> Any:
    """Split every leaf's ``axis`` into a leading microbatch axis,
    ``(..., M*b, ...) → (M, ..., b, ...)``: microbatch ``m`` holds rows
    ``[m*b, (m+1)*b)``, the inverse of :func:`merge_microbatches`.  A batch
    that does not divide raises here, naming the leaf."""
    m = int(microbatches)

    def split(x: torch.Tensor) -> torch.Tensor:
        shape = tuple(x.shape)
        if len(shape) <= axis:
            raise ValueError(f"split_microbatches: leaf of shape {shape} has no axis {axis} to microbatch")
        dim = shape[axis]
        if dim % m != 0:
            raise ValueError(
                f"pipeline: leaf of shape {shape} cannot split axis {axis} "
                f"({dim} rows) into {m} microbatches; batch sizes must be "
                f"multiples of pipeline.microbatches (the same divisibility "
                f"law as fabric.shard_batch's data axis)"
            )
        return x.reshape(shape[:axis] + (m, dim // m) + shape[axis + 1:]).movedim(axis, 0)

    return _tree_map(split, tree)


def merge_microbatches(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """The inverse of :func:`split_microbatches` for one stacked output:
    ``(M, ..., b, ...) → (..., M*b, ...)``."""
    x = x.movedim(0, axis)
    shape = tuple(x.shape)
    return x.reshape(shape[:axis] + (shape[axis] * shape[axis + 1],) + shape[axis + 2:])


def chunked_rows(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, chunks: int) -> torch.Tensor:
    """A per-row ``fn`` over ``chunks`` row chunks of ``x``, one after the
    other (JAX's ``lax.map``); ``fn(x)`` itself at 1.  No row's value
    depends on the chunking.  Under autograd every chunk's activations stay
    alive for the backward, as ``lax.map`` keeps its residuals; the chunks
    bound the size of each head's temporaries.  A row count that does not
    divide raises."""
    c = int(chunks)
    if c <= 1:
        return fn(x)
    n = x.shape[0]
    if n % c != 0:
        raise ValueError(
            f"pipeline: imagination batch of {n} rows cannot split into "
            f"{c} chunks; pipeline.imagination_microbatches must divide the "
            f"(horizon+1)·L·B row count (the same divisibility law as "
            f"fabric.shard_batch's data axis)"
        )
    k = n // c
    return torch.cat([fn(x[i * k:(i + 1) * k]) for i in range(c)], dim=0)


def _boundary(carry: Any) -> Any:
    """A stage's output as the next stage's input: detached, and needing a
    gradient where it carries one, so the next stage's backward hands its
    cotangent down through ``.grad``."""
    def cut(x: Any) -> Any:
        if isinstance(x, torch.Tensor) and x.requires_grad:
            return x.detach().requires_grad_()
        return x

    return _tree_map(cut, carry)


def pipeline_value_and_grad(
    stage_fns: Sequence[Callable[[Any, Any], Any]],
    params: Sequence[torch.Tensor],
    consts: Any,
    *,
    microbatches: int,
    stage_names: Optional[Sequence[str]] = None,
) -> Tuple[torch.Tensor, Any, List[Optional[torch.Tensor]]]:
    """Run a linear stage chain over microbatches in 1F1B order; returns
    ``(loss, aux_stacked, grads)``.

    ``stage_fns[0](None, const_m)`` → carry, middle stages
    ``(carry, const_m)`` → carry, and the last stage returns
    ``(loss_m, aux_m)``, both means over the microbatch.  ``consts`` is a
    tree with a leading microbatch axis ``M`` (data slices, noise drawn
    ahead: nothing in it is differentiated).  ``params`` are the tensors
    the chain trains: their ``.grad`` (empty or zero before the call, as
    after ``zero_grad``) holds the mean of the microbatch gradients after
    it, and ``grads`` is that list.  ``loss`` is the mean of the microbatch
    losses; ``aux_stacked`` keeps the leading ``M`` axis, detached.  Each
    ``B`` unit frees its unit's graph."""
    S = len(stage_fns)
    M = int(microbatches)
    if S < 1:
        raise ValueError("pipeline_value_and_grad: need at least one stage")
    names = list(stage_names) if stage_names is not None else [f"stage{i}" for i in range(S)]
    if len(names) != S:
        raise ValueError(f"pipeline_value_and_grad: {len(names)} names for {S} stages")

    def const_of(m: int) -> Any:
        return _tree_map(lambda x: x[m], consts)

    inputs: Dict[Tuple[int, int], Any] = {}   # stage s's carry input for microbatch m (a leaf of autograd)
    outputs: Dict[Tuple[int, int], Any] = {}  # what B of (s, m) differentiates
    dcarry: Dict[Tuple[int, int], List[Optional[torch.Tensor]]] = {}  # cotangent into stage s's input
    losses: List[Any] = [None] * M
    auxes: List[Any] = [None] * M
    for op, s, m in one_f_one_b(S, M):
        if op == "F":
            cin = None if s == 0 else _boundary(outputs[(s - 1, m)][1])
            inputs[(s, m)] = cin
            out = stage_fns[s](cin, const_of(m))
            if s == S - 1:
                loss_m, aux_m = out
                losses[m] = loss_m.detach()
                auxes[m] = _tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor) else x, aux_m)
                outputs[(s, m)] = ([loss_m], None)
            else:
                outputs[(s, m)] = (_leaves(out), out)
        else:
            outs, _ = outputs.pop((s, m))
            if s == S - 1:
                torch.autograd.backward(outs)
            else:
                cots = dcarry.pop((s + 1, m))
                pairs = [(o, g) for o, g in zip(outs, cots) if g is not None and o.requires_grad]
                if pairs:
                    torch.autograd.backward([o for o, _ in pairs], grad_tensors=[g for _, g in pairs])
            cin = inputs.pop((s, m))
            if s > 0:
                dcarry[(s, m)] = [x.grad if isinstance(x, torch.Tensor) else None for x in _leaves(cin)]
    inv_m = 1.0 / float(M)
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad.mul_(inv_m)
    loss = torch.stack(losses).mean()
    aux_stacked = _stack_trees(auxes)
    return loss, aux_stacked, [p.grad for p in params]


def _stack_trees(trees: List[Any]) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_trees([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


def register_pipeline_metrics(spec: PipelineSpec) -> None:
    """Publish the schedule's shape as hub metrics (``Pipeline/stages``,
    ``Pipeline/microbatches``, ``Pipeline/bubble_frac``); a new run's spec
    replaces the last one's."""
    from sheeprl_tpu_torch.telemetry.hub import HUB

    HUB.register("pipeline", spec.metrics)
