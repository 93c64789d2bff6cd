"""PyTorch/CUDA port of the ``repro`` normalizing-flow package.

The JAX package (``repro``) is the reference; this package mirrors its layout
(``core/``, ``nn/``, ``kernels/``, ``configs/``, ``serve/``) and is held
against it element by element in ``tests/test_torch_*.py``.  It imports
``torch`` and numpy only.

Layout conventions kept from the reference: activations are NHWC, convolution
weights HWIO, multiscale states are Python tuples in the JAX leaf order, and
every kernel sees the (B, M, C) view of ``kernels.common.flatten_bmc``.
"""
