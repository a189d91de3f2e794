"""Hand-written Hopper kernels (csrc/*.cu), their host wrappers and packers."""
