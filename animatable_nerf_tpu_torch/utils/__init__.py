"""Profiling and timing helpers (JAX counterpart: animatable_nerf_tpu/utils/)."""
