"""funny_lidar_slam_torch: the PyTorch/CUDA port of funny_lidar_slam_tpu.

Same module layout and names as the JAX package, which stays the reference
the port is held against. Plain tensor code is PyTorch; each TPU kernel is
a hand-written CUDA kernel for Hopper, built with nvcc at first use:
`csrc/fused_select.cu` (the candidate select of mapping and localization)
and `csrc/probes.cu` (the platform probes, `ops/probes.py`).

Entry points (`SlamSystem`, `Localizer`, `Frontend`, `IcpMatcher`) run on
`cuda` unless the caller passes `device="cpu"`; see `core/device.py`.
"""

import torch as _torch

# Geometry pipelines cannot tolerate TF32 matmuls: residual/Jacobian
# reductions and Lie-group algebra must run in true f32 (the JAX package
# pins jax_default_matmul_precision="highest" for the same reason).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
