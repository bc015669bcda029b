"""PyTorch/CUDA port of the bulk-bitwise PIM database (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``db/``, ``kernels/``) and imports nothing of it. Planes
are ``torch.int32`` tensors carrying the uint32 bit pattern. Entry points
take an explicit ``device`` that defaults to ``"cuda"``.
"""
