"""Checkpointing with atomic manifests (the counterpart of
``repro.checkpoint``)."""
from . import checkpoint  # noqa: F401
