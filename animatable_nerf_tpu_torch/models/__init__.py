"""Models (JAX counterpart: animatable_nerf_tpu/models/)."""
