"""Field modules (JAX counterpart: animatable_nerf_tpu/fields/)."""
