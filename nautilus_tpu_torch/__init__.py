"""nautilus_tpu_torch — the PyTorch/CUDA port of nautilus_tpu.

2D lidar pose-graph SLAM: synthetic ingest -> PCA normals and LOAM features
-> growing-window Levenberg-Marquardt on block-band normal equations ->
automatic loop closure (candidate filter, chi-square gate, correlative scan
matching) -> re-solve -> pose file.  Module paths mirror ``nautilus_tpu``;
the package imports torch, numpy and the standard library, never jax.

The correlative scan matcher's coarse stage runs as a hand-written CUDA
kernel on an NVIDIA Hopper card (kernels/csrc/csm_coarse.cu); every other
step is plain PyTorch on the device the problem lives on.
"""

import torch as _torch

__version__ = "0.1.0"

# The JAX package pins precision=HIGHEST for every contraction that feeds
# the normal equations; TF32 would keep only ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from nautilus_tpu_torch.core.luaconf import load_config  # noqa: E402,F401
from nautilus_tpu_torch.core.problem import (SLAMProblem,  # noqa: E402,F401
                                             SLAMState)
