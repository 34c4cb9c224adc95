"""The benchmark of gsv_tts_tpu_torch on one H100: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The program's kernel libraries build once
per checkout into its own build directory; every other cache goes under
``.bench_cache/`` in the checkout.  See ``harness/cli.py``.
"""
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()
os.environ["GSV_OFFLINE"] = "1"   # never fetch a missing asset
os.environ["USE_FLAX"] = "0"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path[:0] = [str(ROOT), str(HERE)]

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
