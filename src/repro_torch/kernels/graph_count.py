"""Count the CUDA kernels one call enqueues, with no CUPTI tracing.

:func:`kernels_enqueued` captures one call into a CUDA graph on a side
stream and counts the graph's kernel nodes (``capture_begin`` /
``capture_end_count`` of ``csrc/timing.cu``: ``cudaStreamBeginCapture``
in relaxed mode, ``cudaGraphGetNodes``, ``cudaGraphNodeGetType``). During
a capture nothing runs; the call's launches become nodes. A profiler's
device events come from CUPTI and a window can come back empty; a capture
yields its graph or a CUDA error, so a count of 0 means the call enqueued
no kernel, never that the method saw nothing.

The call is made once on the same stream before the capture, so whatever
a wrapper builds on a stream's first call (its library, its per-stream
state, the allocator's blocks for that stream) exists before the capture
starts and is not part of the count.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from . import build

METHOD = ("CUDA graph capture (cudaStreamBeginCapture, relaxed mode; "
          "cudaGraphGetNodes and cudaGraphNodeGetType count kernel nodes)")


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.capture_begin.argtypes = [p]
    lib.capture_begin.restype = i
    lib.capture_end_count.argtypes = [p, ctypes.POINTER(i),
                                      ctypes.POINTER(i)]
    lib.capture_end_count.restype = i


def kernels_enqueued(fn: Callable[[], object]) -> Tuple[int, int]:
    """``(kernel nodes, all nodes)`` of one warm call of ``fn`` captured on
    a side stream of the current device. Raises a ``RuntimeError`` that
    names the method when the capture fails."""
    lib = build.library("timing", _bind)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    kernels, nodes = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.stream(stream):
        err = lib.capture_begin(stream.cuda_stream)
        if err:
            raise RuntimeError(f"{METHOD}: cudaStreamBeginCapture failed "
                               f"with CUDA error {err}")
        try:
            fn()
        finally:
            err = lib.capture_end_count(stream.cuda_stream,
                                        ctypes.byref(kernels),
                                        ctypes.byref(nodes))
    if err:
        raise RuntimeError(f"{METHOD}: the capture failed with CUDA error "
                           f"{err}")
    return kernels.value, nodes.value
