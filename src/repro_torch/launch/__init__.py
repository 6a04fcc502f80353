"""Entry points of the port (``python -m repro_torch.launch.registration``,
``python -m repro_torch.launch.serve``)."""
