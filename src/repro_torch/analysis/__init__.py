"""PIM-IR static verifier: pass framework, diagnostics, lint driver.

The counterpart of ``repro.analysis``. ``diagnostics`` is stdlib-only
and re-exported eagerly, so ``core.cost_model`` (and anything else that
only needs the diagnostic types) can import it without the core modules.
The pass framework (``analysis.passes``) imports the core modules, so
its entry points are re-exported through thin lazy wrappers.

``python -m repro_torch.analysis.lint`` runs every pass over every
program the database emits (see ``analysis/lint.py``).
"""
from .diagnostics import (Diagnostic, ProgramVerificationError,
                          SEVERITIES, count_by_severity,
                          format_diagnostics)

__all__ = [
    "Diagnostic", "ProgramVerificationError", "SEVERITIES",
    "count_by_severity", "format_diagnostics",
    "build_context", "run_passes", "verify_compile", "verify_context",
    "verify_program", "write_profile",
]


def build_context(*args, **kwargs):
    from . import passes
    return passes.build_context(*args, **kwargs)


def run_passes(*args, **kwargs):
    from . import passes
    return passes.run_passes(*args, **kwargs)


def verify_context(*args, **kwargs):
    from . import passes
    return passes.verify_context(*args, **kwargs)


def verify_program(*args, **kwargs):
    from . import passes
    return passes.verify_program(*args, **kwargs)


def verify_compile(*args, **kwargs):
    from . import passes
    return passes.verify_compile(*args, **kwargs)


def write_profile(*args, **kwargs):
    from . import endurance
    return endurance.write_profile(*args, **kwargs)
