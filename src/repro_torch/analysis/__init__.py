"""What the cost model needs of the reference's PIM-IR verifier package
(``repro.analysis``): the diagnostic types and the trace's write
profile. The verifier itself — the pass framework, its passes (the
``endurance`` pass among them) and the hook into ``compile_program`` —
is not ported yet (ROADMAP A9).
"""
from .diagnostics import (Diagnostic, ProgramVerificationError,
                          SEVERITIES, count_by_severity,
                          format_diagnostics)
from .endurance import WriteProfile, write_profile

__all__ = [
    "Diagnostic", "ProgramVerificationError", "SEVERITIES",
    "WriteProfile", "count_by_severity", "format_diagnostics",
    "write_profile",
]
