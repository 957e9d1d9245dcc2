"""Benchmarks and timing experiments of the port, run on a CUDA card."""
