"""The image-space baselines NHR and NT (JAX counterpart:
animatable_nerf_tpu/baselines/): PointNet++ MSG, the point splatter and
the gated UNet; the neural texture and the same UNet. Plain PyTorch:
no kernel of the TPU lies on their path."""
