"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

``ref`` holds the plain PyTorch versions; ``nn_search`` (brute-force NN),
``nn_search_grid`` (grid candidate sweep), ``fused_icp`` (fused
point-to-point and point-to-plane moment pass) and ``normals`` (normals
moment sweep) the kernel wrappers; ``ops`` the padded
entry points of the brute-force kernel and ``build`` the ``nvcc`` build. Sources
live in ``csrc/`` and are compiled on the machine with the card, on first
use; importing this package compiles nothing.
"""
