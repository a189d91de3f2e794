"""PyTorch / CUDA port of the raytracingthenextweekcuda_tpu path tracer.

The JAX package beside this one is the reference; each module here mirrors
the file of the same path there. This package imports torch and numpy only:
host packing and RNG key words are numpy, rendering runs on torch tensors,
and the hot path is one hand-written Hopper kernel (csrc/render_kernel.cu)
with a plain torch version beside it for CPU tensors.
"""
