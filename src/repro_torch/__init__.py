"""repro_torch — FlashDecoding++ on an NVIDIA H100: the PyTorch + CUDA port
of the JAX package ``repro``, with hand-written Hopper kernels under
``csrc/``. It mirrors ``repro``'s module tree and public names; it imports
neither JAX nor ``repro``."""

__version__ = "0.1.0"
