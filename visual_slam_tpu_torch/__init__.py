"""visual_slam_tpu_torch — the PyTorch / CUDA port of visual_slam_tpu.

The module layout mirrors the JAX package, so each module's counterpart has
the same name there. The port imports torch and numpy only, never jax. The
Pallas kernels of the JAX package's main path are hand-written CUDA C++ for
Hopper here (`csrc/`, built at first use by `ops/kernels/build.py`).
"""

import torch as _torch

# Every float32 matmul and convolution runs in full float32. SLAM geometry
# (pose chains, Gauss-Newton normal equations, pose updates) is iterative
# f32 math where reduced-precision inputs compound into centimetres of
# trajectory error: in the JAX package, default (bf16-input) matmul
# precision moved ATE from 0.018 to 0.062 on ICL-NUIM lr traj3. TF32 keeps
# ~10 mantissa bits, the same hazard. The one deliberate reduced-precision
# product, the descriptor sampling matmul, rounds its inputs to bf16
# explicitly (ops/descriptor_mxu.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
