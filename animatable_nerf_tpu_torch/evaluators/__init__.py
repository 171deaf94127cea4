"""Evaluators (JAX counterpart: animatable_nerf_tpu/evaluators/)."""
