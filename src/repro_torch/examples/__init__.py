"""Runnable examples of the port, the counterparts of the repository's
``examples/quickstart.py`` and ``examples/tpch_analytics.py``:
``python -m repro_torch.examples.<name> [--device cuda|cpu]``."""
