"""Renderers (JAX counterpart: animatable_nerf_tpu/render/)."""
