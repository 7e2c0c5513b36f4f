"""PyTorch/CUDA port of the speecht5_tpu package.

Imports torch, never JAX, and nothing of ``speecht5_tpu``.  Entry points take
an explicit ``device`` that defaults to ``"cuda"``; the CPU runs only when a
caller asks for ``device="cpu"`` (the tests do).
"""
