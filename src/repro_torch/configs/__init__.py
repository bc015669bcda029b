"""Architecture configs (one module per assigned arch) + shape registry."""
from .common import SHAPES, ModelConfig, MoEConfig, ShapeConfig, SSMConfig, cell_is_runnable  # noqa: F401
from .registry import ARCH_IDS, all_configs, get_config, get_smoke_config  # noqa: F401
