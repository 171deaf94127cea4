"""Training of the port (JAX counterpart: animatable_nerf_tpu/train/)."""
