"""PyTorch/CUDA port of the ``repro`` package.

Same module layout as the JAX reference: each module here has its
reference at the same relative path under ``repro``.  This package never
imports ``jax`` or ``repro``; entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
