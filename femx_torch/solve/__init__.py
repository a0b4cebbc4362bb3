"""Solvers: PCG and FCG, mixed-precision refinement, dense Cholesky, structured
multigrid and the lattice-multigrid preconditioner of unstructured meshes."""
