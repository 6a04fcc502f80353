"""The train step and checkpoints (port of ``repro.train``)."""
