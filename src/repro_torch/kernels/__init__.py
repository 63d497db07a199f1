"""Hopper kernels of the port (CUDA C++ and Triton) and their plain
PyTorch versions; ``ops`` dispatches between them by tensor device."""
