"""Iterative solvers: PCG, mixed-precision refinement, structured multigrid."""
