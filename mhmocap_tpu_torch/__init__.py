"""PyTorch/CUDA port of mhmocap_tpu (scene-aware 3D multi-human motion
capture), held module by module against the JAX package.

Module names mirror `mhmocap_tpu` so that every function has an obvious
counterpart. The package imports torch and numpy only; the raster
kernels under `ops/csrc/` are compiled with nvcc at first use on a
CUDA device.

The JAX package runs its SMPL, camera and loss contractions at
`Precision.HIGHEST`; TF32 is switched off here so that float32 matmuls
and convolutions (the Sobel filter) stay float32 on the GPU as well.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
