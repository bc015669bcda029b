"""Stand-ins for every model input, per (arch x shape), with no allocation.

The counterpart of ``repro.launch.input_specs``: where the reference gives
``ShapeDtypeStruct``s, the port gives tensors on the ``meta`` device (the
dry-run makes zero pieces of them under ``FakeTensorMode``), in the
reference's layout (``models.convert.reference_params``: a stacked group
is one ``(L, ...)`` leaf). Nothing is drawn or allocated, even for
llama4-maverick's 400 B parameters.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.common import ModelConfig, ShapeConfig
from ..models import convert
from ..models.layers import torch_dtype
from ..models.lm import LM

ENC_STUB_LEN = 4096   # whisper encoder stub length for decode shapes


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((B, S), torch.int32),
             "labels": _meta((B, S), torch.int32), "extra": None}
    if cfg.frontend == "vision_stub":
        specs["extra"] = _meta((B, cfg.n_frontend_tokens, cfg.d_model),
                               torch.bfloat16)
    elif cfg.frontend == "audio_stub":
        specs["extra"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Tuple[Any, ...]:
    """(cache, tokens, pos) for the serve step; an encdec cache's
    ``cross`` holds ``ENC_STUB_LEN`` encoder positions."""
    B, T = shape.global_batch, shape.seq_len
    cache = LM(cfg, device="meta").init_cache(B, T)
    if cfg.block_pattern == "encdec":
        kv = (cfg.n_layers, B, ENC_STUB_LEN, cfg.eff_n_kv_heads, cfg.head_dim)
        cache["cross"] = (_meta(kv, torch_dtype(cfg.dtype)),
                          _meta(kv, torch_dtype(cfg.dtype)))
    return cache, _meta((B, 1), torch.int32), 0


def params_struct(cfg: ModelConfig):
    """The parameters in the reference's layout, as empty tensors."""
    return convert.reference_params(LM(cfg, device="meta"))
