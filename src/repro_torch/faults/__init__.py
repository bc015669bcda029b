"""Fault tolerance for the PIM database stack.

The counterpart of ``repro.faults``: device-fault injection (``model``),
XOR-parity guard-plane integrity (``guard``), detection + self-healing
repair (``recovery``), and the deterministic chaos harness that soaks
the serving stack under injected faults (``chaos``). The planes stay on
the relation's device throughout: the parity reduce, the read-back of
written words and the injected corruption run there.
"""
from repro_torch.faults.guard import RelationGuard
from repro_torch.faults.model import DeviceFaultModel, TransientDispatchError
from repro_torch.faults.recovery import (CircuitBreaker, FaultManager,
                                         RetryPolicy)

__all__ = [
    "CircuitBreaker",
    "DeviceFaultModel",
    "FaultManager",
    "RelationGuard",
    "RetryPolicy",
    "TransientDispatchError",
]
