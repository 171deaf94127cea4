"""Geometry and rendering math of the port (JAX counterpart:
animatable_nerf_tpu/core/)."""
