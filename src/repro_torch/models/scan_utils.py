"""The dry-run's model overrides.

The counterpart of ``repro.models.scan_utils``. The reference's layer and
sequence loops are ``lax.scan``s, which XLA's cost analysis counts once a
loop; its dry-run sets ``UNROLL_SCANS`` so they become Python loops. The
port's loops are Python loops already (one module a layer, the flash
blocks, the recurrent time steps), so every iteration is counted:
``UNROLL_SCANS`` is the reference's name for that, always true here, and
nothing reads it.

``FLASH_Q_BLOCK``/``FLASH_KV_BLOCK`` (``None``: the call site's default)
override ``models.flash.flash_attention``'s block sizes, as the
reference's ``flash.py`` reads them. The dry-run sets coarser blocks so a
long sequence runs fewer (and larger) block steps on fake tensors.
"""
from __future__ import annotations

UNROLL_SCANS = True
FLASH_Q_BLOCK = None
FLASH_KV_BLOCK = None
