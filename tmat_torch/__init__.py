"""PyTorch/CUDA port of tmat_tpu's plate pipeline, for NVIDIA Hopper.

The module layout mirrors ``tmat_tpu``. Entry points run on a CUDA
device unless the caller passes ``device="cpu"`` (``tmat_torch.device``).
Importing the package imports nothing heavy and builds nothing.
"""

__version__ = "0.1.0"
