"""Visualizers (JAX counterpart: animatable_nerf_tpu/visualizers/)."""
