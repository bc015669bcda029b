"""Bit-plane layout, ISA, word primitives and the fused program executor."""
