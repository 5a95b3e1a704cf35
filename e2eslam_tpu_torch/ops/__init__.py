"""Exact KNN (dispatcher, CUDA kernels, plain versions) and the Morton sort."""
