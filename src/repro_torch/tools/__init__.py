"""Tools of the port, run as ``python -m repro_torch.tools.<name>``:
``autotune_fused`` sweeps the fused kernel's launch settings on the card
(port of the repository's ``tools/autotune_fused.py``)."""
