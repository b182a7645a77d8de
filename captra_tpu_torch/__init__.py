"""captra_tpu_torch: PyTorch + CUDA port of `captra_tpu` for NVIDIA Hopper.

The JAX package `captra_tpu` is the reference; this package imports nothing
from it (nor JAX) and keeps its module layout, so each module here has its
counterpart under the same path there:

  config    -- typed config dataclasses + YAML loader (own copy)
  utils     -- fp32 (TF32-off) precision scope
  pose      -- rotations, Procrustes, per-part pose algebra, metrics
  ops       -- point-cloud ops; FPS as hand-written CUDA kernels (csrc/)
  models    -- PointNet++ backbone, CoordNet, RotNet (torch.nn)
  tracking  -- the frame-recurrent tracking loop
  training  -- flax-variables -> port-module converter
  data      -- numpy synthetic trajectories

Entry points run on CUDA unless the caller passes `device="cpu"`; without a
card and without an explicit device they raise.
"""

__version__ = "0.1.0"
