"""Utilities for the port: matmul precision control and CUDA timing."""
