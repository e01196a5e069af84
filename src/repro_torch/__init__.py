"""PyTorch/CUDA port of ``repro``: the same configs, models and serve
engine, with the TPU's Pallas kernels rewritten by hand for Hopper.

The package imports torch, numpy and the standard library only — never
``jax`` nor ``repro`` — so it runs on a GPU host without JAX.
"""
