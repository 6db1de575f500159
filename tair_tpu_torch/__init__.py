"""PyTorch/CUDA port of the text-aware image restoration system.

Sub-packages and modules carry the names of their counterparts in the JAX
package, so ``tair_tpu_torch/ops/flash_attention.py`` is the port of
``tair_tpu/ops/flash_attention.py``. The port imports torch and numpy only
(and scipy inside the matcher's host solve and the sinc blur kernel of the
data pipeline); PIL only where an image file is decoded.
"""

__version__ = "0.1.0"
