"""Model definitions: layers, attention, MoE, SSM, xLSTM, LM assembly (the
counterpart of ``repro.models``), and ``convert`` to carry the
reference's weights across."""
from . import attention, convert, flash, layers, lm, moe, ssm, xlstm  # noqa: F401
from .convert import load_reference_params  # noqa: F401
from .lm import LM  # noqa: F401
