"""Counterparts of femx's Pallas repros and gather sweep under examples/,
each running the port's hand-written CUDA kernel on the same inputs."""
