"""PyTorch port of the disaggregated serving system for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro`` module for module, so
each counterpart sits at the same path.  The port imports ``torch`` and
never ``jax``, and nothing of ``repro``: what it shares with the
reference (configs, request model, chunking, schedulers) is its own
copy.  Attention runs through hand-written CUDA kernels
(``kernels/csrc``) on CUDA tensors and through their plain PyTorch
versions on CPU tensors.
"""
