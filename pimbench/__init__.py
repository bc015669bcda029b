"""The benchmark of the PyTorch/CUDA port (``repro_torch``): TPC-H query
and refresh streams through ``QueryService`` on one card. See README.md."""
