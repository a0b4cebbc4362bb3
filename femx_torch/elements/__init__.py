"""Tet10 element kernels (einsum and element-last layouts) and the
structured cell-matmul kernel wrapper."""
