"""Distribution (the counterpart of ``repro.distributed``): so far the
int8 gradient compression; the sharding rules and pipeline parallelism
come with the mesh tooling."""
from . import compression  # noqa: F401
