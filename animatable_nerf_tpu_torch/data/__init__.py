"""Host data pipeline of the port (JAX counterpart:
animatable_nerf_tpu/data/)."""
