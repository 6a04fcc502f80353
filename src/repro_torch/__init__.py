"""FPPS on PyTorch and CUDA: the port of the JAX package ``repro``.

The port keeps the reference's module layout (``core``, ``data``,
``kernels``) so each module's counterpart is easy to find, and holds itself
to the reference in ``tests/test_torch_*.py``. It imports ``torch`` and
numpy, never ``jax`` or anything under ``repro``.

Entry points (``core.FppsICP``, ``core.get_engine`` and the engines'
``register*`` methods) run on the card unless the caller passes
``device="cpu"``; without CUDA they raise rather than fall back. The
brute-force nearest-neighbour search behind the ``"cuda"`` engine is a
hand-written CUDA kernel (``kernels/csrc/nn_search.cu``), built with
``nvcc`` on first use.
"""
