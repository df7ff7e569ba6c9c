"""PyTorch/CUDA port of old_kaldi_git_tpu for NVIDIA Hopper.

Same sub-package and module names as the JAX package, so a reader finds
each counterpart; inside, PyTorch idiom: nn.Modules, plain functions on
tensors, an explicit `device` argument.  The package imports torch and
numpy only — never jax, flax or the JAX package.

Numerics: float32 throughout.  Matrix products run in full float32, not
TF32 (TF32 keeps ~3 decimal digits; MFCC power bins reach 1e9 and the
decoder compares path costs to 1e-3), so both switches are stated and set
here, once, at import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
