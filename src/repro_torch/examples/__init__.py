"""Runnable examples of the port, the counterparts of the repository's
``examples/quickstart.py``, ``examples/tpch_analytics.py``,
``examples/analytics_guided_serving.py`` and ``examples/train_lm.py``:
``python -m repro_torch.examples.<name> [--device cuda|cpu]``."""
