"""PyTorch/CUDA port of the text-aware image restoration system.

Sub-packages and modules carry the names of their counterparts in the JAX
package, so ``tair_tpu_torch/ops/flash_attention.py`` is the port of
``tair_tpu/ops/flash_attention.py``. The port imports torch and numpy only
(and scipy in the data pipeline's sinc blur kernel and in NIQE); PIL only
where an image file is decoded or resized or the overlay is drawn. Its CUDA
kernels (``ops/csrc``) are built with nvcc and its native host helpers
(``native/``) with g++, each at first use.
"""

__version__ = "0.1.0"
