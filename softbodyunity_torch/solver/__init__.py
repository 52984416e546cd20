"""Solver pieces that run outside the fused kernels."""
