"""Numerics policies, attention, and the CUDA kernels with their plain versions."""
