"""PyTorch/CUDA port of tdc_video_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module paths and function names; parameters keep
the JAX layout (nested dicts, weights [d_in, d_out] applied as x @ w, layers
stacked on axis 0).  Imports torch and numpy only, never jax or tdc_video_tpu.
Entry points run on CUDA unless the caller passes device="cpu".
"""
