"""Operators of the port; kernels live in subpackages by route."""
