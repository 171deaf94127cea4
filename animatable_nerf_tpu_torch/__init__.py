"""PyTorch/CUDA port of animatable_nerf_tpu for NVIDIA Hopper GPUs.

The layout mirrors the JAX package (`core/`, `fields/`, `ops/`,
`models/`, `render/`, `data/`, `config/`, `evaluators/`, `compat/`,
`engine.py`, `run.py`), so each module's counterpart is found by path.
The package imports torch, numpy, scipy, einops and the standard
library only; it never imports jax, flax or the JAX package.

Entry points run on `cuda` unless the caller passes `device="cpu"`
(device.py). The fused skip-MLP (ops/skip_mlp.py), the KNN blend and
the nearest-vertex distance (ops/knn.py) are hand-written CUDA kernels
built from csrc/ at first use.
"""
