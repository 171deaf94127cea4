"""The port's copies of the repository's host tools, each run as
`python -m animatable_nerf_tpu_torch.tools.<name>` with the flags of the
tool of the same name under tools/."""
