"""Hand-written GPU kernels and their plain versions (JAX counterpart:
animatable_nerf_tpu/ops/)."""
