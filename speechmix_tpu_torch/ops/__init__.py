"""Tensor ops of the port: layers, masking, attention and the kernels."""
