"""The frozen plain reference: plain PyTorch and NumPy that imports nothing
of the program (``repro_torch``) or of the JAX package."""
