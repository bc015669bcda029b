"""One reader a metric: ``<name>.py`` (dots and dashes of the metric's
name read as underscores) with ``read(run) -> float | None``, where
``run`` is a ``harness.Run``. A reader that finds nothing to read returns
None, and the metric is left out of the result line."""
