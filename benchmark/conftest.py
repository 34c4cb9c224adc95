"""The benchmark's CPU tests build a tiny copy of the benchmark
(``tests/tiny.py``); with GPT-SoVITS v4's configuration in ``configs/`` the
copy needs v4's tiny leaf tables too, which ``tests/tiny_v4.py`` adds."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

import tiny_v4  # noqa: E402

tiny_v4.install()
