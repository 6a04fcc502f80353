"""Entry points of the port (``python -m repro_torch.launch.registration``,
``.serve``, ``.train`` and ``.dryrun``) and the partition rules
(``launch.mesh``, ``launch.partition``, ``launch.specs``)."""
