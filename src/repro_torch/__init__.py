"""repro_torch: the FENIX co-simulator in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (H100).

A port of the JAX package ``repro`` that mirrors its module paths one
for one (``repro_torch/core/data_engine/engine.py`` ports
``repro/core/data_engine/engine.py``).  It imports torch and numpy only,
never JAX and never ``repro``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on a host without CUDA they raise.
"""

from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: F401

__version__ = "0.1.0"
