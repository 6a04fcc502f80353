"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

``ref`` holds the plain PyTorch versions, ``nn_search`` the kernel wrapper,
``ops`` the padded entry points and ``build`` the ``nvcc`` build. Sources
live in ``csrc/`` and are compiled on the machine with the card, on first
use; importing this package compiles nothing.
"""
