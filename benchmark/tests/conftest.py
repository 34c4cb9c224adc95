"""The benchmark's CPU tests import the harness, the reference and the tiny
copy builder from the benchmark's folder."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)
