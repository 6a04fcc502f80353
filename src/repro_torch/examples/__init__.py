"""The drivers of the port (ports of the repository's ``examples/``), run
as ``python -m repro_torch.examples.<name>``: ``quickstart`` (the Table-I
API on one frame pair), ``odometry`` (scan-to-map or frame-to-frame over a
synthetic sequence), ``fleet_registration`` (many pairs in one batched
engine call) and ``serve_lm`` (the legacy LM stack's batched generate).
Each runs on ``--device`` (default ``cuda``; raises without a card) and
its ``main(argv)`` returns what it printed its verdict on."""
