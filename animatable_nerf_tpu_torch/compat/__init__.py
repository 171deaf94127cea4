"""Weight interchange with the JAX package (JAX counterpart:
animatable_nerf_tpu/compat/)."""
