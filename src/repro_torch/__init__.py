"""PyTorch/CUDA port of the DDS serving system (``repro``) for NVIDIA Hopper.

The package mirrors ``src/repro/``'s layout module for module, imports
``torch`` and numpy only, and never imports ``jax`` or anything of the JAX
package.  Attention and normalisation run through hand-written Hopper
kernels (``repro_torch.kernels``); a CPU tensor takes each kernel's plain
PyTorch version instead.
"""
