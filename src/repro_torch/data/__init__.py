"""Data pipeline (the counterpart of ``repro.data``): bulk-bitwise example
selection and the token batcher."""
from .pipeline import CorpusMeta, PimDataSelector, TokenBatcher  # noqa: F401
