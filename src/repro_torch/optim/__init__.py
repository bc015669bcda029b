"""Optimizers and schedules (the counterpart of ``repro.optim``)."""
from .optimizers import (adafactor_init, adafactor_update, adamw_init,  # noqa: F401
                         adamw_update, clip_by_global_norm, make_optimizer,
                         wsd_schedule)
