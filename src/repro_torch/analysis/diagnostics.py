"""Shared diagnostic type of the PIM-IR static verifier.

The verifier's passes (``analysis/passes.py``) report findings as
:class:`Diagnostic` values — one finding per instance, carrying the pass
name, severity, the offending instruction index/kind and register, and a
human-readable message. Compiler-side failures (``compile_program``,
``classify_program``, ``classify_lowering``) reuse the same type via
:class:`ProgramVerificationError` so every failure in the stack names the
instruction it is about.

This module is stdlib-only by design: ``core.cost_model`` imports it, so
it must not pull in the core modules transitively.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

#: Ordered from most to least severe. ``error`` means the program would
#: execute incorrectly (or not at all); ``warning`` flags hazards that are
#: semantically defined but almost certainly unintended (truncation, cost
#: drift, leaked registers); ``info`` is reporting (endurance hotspots).
SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding, localized to an instruction and register."""
    pass_name: str                       # e.g. "defuse", "kinds"
    severity: str                        # "error" | "warning" | "info"
    message: str
    instr_index: Optional[int] = None    # position in the ISA trace
    instr_kind: Optional[str] = None     # e.g. "Multiply"
    register: Optional[str] = None       # the register/attr at fault

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def is_error(self) -> bool:
        return self.severity == "error"

    def format(self) -> str:
        where = "" if self.instr_index is None else f"@{self.instr_index}"
        kind = f" {self.instr_kind}" if self.instr_kind else ""
        reg = f" '{self.register}'" if self.register else ""
        return (f"[{self.severity}] {self.pass_name}{where}{kind}{reg}: "
                f"{self.message}")


def format_diagnostics(diags: Iterable[Diagnostic]) -> str:
    return "\n".join(d.format() for d in diags)


def count_by_severity(diags: Iterable[Diagnostic]) -> dict:
    out = dict.fromkeys(SEVERITIES, 0)
    for d in diags:
        out[d.severity] += 1
    return out


class ProgramVerificationError(ValueError):
    """A program failed static verification (or a localized compile error).

    Subclasses ``ValueError`` so existing callers that treat compile
    failures as value errors (and tests asserting ``ValueError``) keep
    working; the payload is the full diagnostic list, pre-formatted into
    the exception message.
    """

    def __init__(self, diagnostics: Sequence[Diagnostic],
                 header: str = "program verification failed"):
        self.diagnostics: Tuple[Diagnostic, ...] = tuple(diagnostics)
        errors = [d for d in self.diagnostics if d.is_error]
        shown = errors or list(self.diagnostics)
        super().__init__(header + ":\n" + format_diagnostics(shown))

    @classmethod
    def single(cls, pass_name: str, message: str,
               instr_index: Optional[int] = None,
               instr_kind: Optional[str] = None,
               register: Optional[str] = None,
               header: str = "program verification failed"
               ) -> "ProgramVerificationError":
        return cls([Diagnostic(pass_name, "error", message,
                               instr_index=instr_index,
                               instr_kind=instr_kind, register=register)],
                   header=header)
