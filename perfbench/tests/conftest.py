"""Tests of the benchmark itself (not collected by the repository's tier-1
run, whose ``testpaths`` is ``tests``):

    python -m pytest -q perfbench/tests            # CPU
    python -m pytest -q -m cuda perfbench/tests    # on a CUDA card
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
