"""Pass framework of the PIM-IR static verifier.

The counterpart of ``repro.analysis.passes``. A *pass* is a function
``(PassContext) -> List[Diagnostic]`` registered under a name with
:func:`register_pass`. The context carries one relation program plus
everything ``compile_program`` derives from it (liveness analysis, reduce
plan, arith plan, free schedule), so passes can re-prove the planner's
claims independently and report disagreements as localized diagnostics
instead of wrong query results.

Backends are the schedules the port really has:

* ``"eager"`` — ``core.engine.Engine``, one instruction at a time: reduces
  execute at their own position and nothing is freed (no plans, no
  frees). Its rules are the reference's ``"trace"`` backend's.
* ``"fused"`` — ``core.program``'s one lowering, on the CPU and on the
  card alike: the tape follows the reference Pallas kernel's schedule and
  ``Materialize`` streams source planes through the materialize kernel.
  Its rules are the reference's ``"pallas"`` backend's.

:data:`REFERENCE_BACKEND` maps each to the reference backend whose rules
it shares; the reference's ``"jnp"`` lowering has no counterpart here.

What is verified is the planner's schedule (``frees_by_instr``, the
reduce jobs' ``exec_at``, the arith batches' anchors). The tape recorder
then re-orders the recorded plane-op DAG depth-first for few live slots
(``kernels.program.TapeRecorder.finish``); that re-ordering lies outside
what these passes check, as the reference has no tape to check either.

Entry points:

* :func:`build_context` — replicate ``compile_program``'s static front
  half (analysis + plans + frees) for a raw instruction list, without
  recording any tape.
* :func:`run_passes` — run all (or selected) passes, return diagnostics.
* :func:`verify_context` / :func:`verify_program` — run passes and raise
  :class:`~repro_torch.analysis.diagnostics.ProgramVerificationError` on
  any error-severity diagnostic.

``compile_program`` calls :func:`verify_compile` on every tape-cache miss,
before the tape is recorded, so verification is always on at compile time
and adds no work to the warm path.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, FrozenSet, List, Mapping, Optional,
                    Sequence, Tuple)

from repro_torch.core import engine as eng
from repro_torch.core import isa
from repro_torch.core import program as prog

from .diagnostics import Diagnostic, ProgramVerificationError

BACKENDS = ("eager", "fused")
#: The reference backend whose schedule and rules each port backend shares.
REFERENCE_BACKEND = {"eager": "trace", "fused": "pallas"}


@dataclasses.dataclass(frozen=True)
class PassContext:
    """One relation program and the compile-time facts passes check.

    ``backend="eager"`` models the eager engine: reduces execute at their
    own position and nothing is freed, so ``plan``/``arith``/``frees``
    are None. ``"fused"`` carries the plans and the exact free schedule
    the lowering uses.
    """
    instrs: Tuple[isa.PimInstruction, ...]
    source_widths: Mapping[str, int]        # relation attr -> planes
    keep: FrozenSet[str]                    # registers pinned as outputs
    backend: str = "eager"
    analysis: Optional[prog.ProgramAnalysis] = None
    plan: Optional[prog.ReducePlan] = None
    arith: Optional[prog.ArithPlan] = None
    frees: Optional[Tuple[Tuple[str, ...], ...]] = None

    def is_source(self, name: str) -> bool:
        return name in self.source_widths


PassFn = Callable[[PassContext], List[Diagnostic]]
PASSES: Dict[str, PassFn] = {}


def register_pass(name: str) -> Callable[[PassFn], PassFn]:
    def deco(fn: PassFn) -> PassFn:
        PASSES[name] = fn
        return fn
    return deco


_PASSES_LOADED = False


def _ensure_passes_loaded() -> None:
    # The pass modules import this module for the registry, so they are
    # loaded lazily on first use rather than at import time.
    global _PASSES_LOADED
    if not _PASSES_LOADED:
        from . import batches, defuse, endurance, kinds  # noqa: F401
        _PASSES_LOADED = True


def build_context(relation: eng.PimRelation,
                  instrs: Sequence[isa.PimInstruction],
                  mask_outputs: Sequence[str] = (),
                  backend: str = "fused",
                  frees: Optional[Tuple[Tuple[str, ...], ...]] = None
                  ) -> PassContext:
    """Derive a PassContext the way ``compile_program`` would.

    Mirrors the compile pipeline exactly: the pinned ``keep`` set is the
    requested mask outputs plus every Materialize mask, the plans come
    from ``plan_reduces``/``plan_arith``, and (unless overridden, which
    the mutation tests use to seed corrupted schedules) ``frees`` is the
    ``frees_by_instr`` schedule the lowering executes.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    instrs = tuple(instrs)
    mask_outputs = tuple(mask_outputs)
    mat_masks = []
    for ins in instrs:
        if ins.kind == "Materialize" and ins.mask not in mat_masks:
            mat_masks.append(ins.mask)
    keep = mask_outputs + tuple(m for m in mat_masks
                                if m not in mask_outputs and m != "__valid__")
    analysis = prog.analyze_program(instrs, relation, keep=keep)
    source_widths = {a: relation.width_of(a) for a in relation.planes}
    plan = arith = None
    if backend != "eager":
        widths = {a: source_widths[a] for a in analysis.source_attrs}
        plan = prog.plan_reduces(instrs, analysis, widths)
        arith = prog.plan_arith(instrs, analysis, widths)
        if frees is None:
            frees = prog.frees_by_instr(len(instrs), plan.last_use,
                                        frozenset(keep))
    return PassContext(instrs=instrs, source_widths=source_widths,
                       keep=frozenset(keep), backend=backend,
                       analysis=analysis, plan=plan, arith=arith,
                       frees=frees)


def run_passes(ctx: PassContext,
               names: Optional[Sequence[str]] = None
               ) -> Tuple[Diagnostic, ...]:
    """Run the requested passes (default: all registered) over one
    context; diagnostics come back in pass-registration order."""
    _ensure_passes_loaded()
    selected = tuple(PASSES) if names is None else tuple(names)
    out: List[Diagnostic] = []
    for name in selected:
        out.extend(PASSES[name](ctx))
    return tuple(out)


def verify_context(ctx: PassContext,
                   names: Optional[Sequence[str]] = None
                   ) -> Tuple[Diagnostic, ...]:
    """Run passes; raise ProgramVerificationError on any error finding."""
    diags = run_passes(ctx, names)
    if any(d.is_error for d in diags):
        raise ProgramVerificationError(diags)
    return diags


def verify_program(relation: eng.PimRelation,
                   instrs: Sequence[isa.PimInstruction],
                   mask_outputs: Sequence[str] = (),
                   backend: str = "fused") -> Tuple[Diagnostic, ...]:
    """One-call verification of a raw relation program (no tape built)."""
    return verify_context(build_context(relation, instrs, mask_outputs,
                                        backend=backend))


def verify_compile(instrs: Tuple[isa.PimInstruction, ...],
                   relation: eng.PimRelation,
                   analysis: prog.ProgramAnalysis,
                   plan: prog.ReducePlan,
                   arith: prog.ArithPlan,
                   keep: FrozenSet[str],
                   backend: str) -> Tuple[Diagnostic, ...]:
    """The ``compile_program`` hook: verify using the analysis/plans the
    compile pipeline already computed (nothing is re-derived), raising a
    localized ProgramVerificationError on error findings."""
    source_widths = {a: relation.width_of(a) for a in relation.planes}
    frees = prog.frees_by_instr(len(instrs), plan.last_use, keep)
    ctx = PassContext(instrs=instrs, source_widths=source_widths,
                      keep=keep, backend=backend, analysis=analysis,
                      plan=plan, arith=arith, frees=frees)
    return verify_context(ctx)
