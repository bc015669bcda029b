"""Distribution (the counterpart of ``repro.distributed``): the int8
gradient compression, the sharding rules and the shard store
(``sharding``), the steps on a mesh (``sharded_steps``) and pipeline
parallelism (``pipeline_parallel``)."""
from . import compression  # noqa: F401
