"""Benchmarks of the port, run on a CUDA card."""
