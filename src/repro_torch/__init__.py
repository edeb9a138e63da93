"""PyTorch/CUDA port of the TACC execution substrate (see ROADMAP.md).

Imports torch and numpy only: nothing of jax or of the JAX package.
"""
