"""Accuracy oracle and the CUDA kernel build."""
