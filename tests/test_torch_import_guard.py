"""The port stays free of JAX: every module of ``gsv_tts_tpu_torch`` imports
in a fresh interpreter whose import system refuses ``jax``, ``jaxlib``,
``optax``, the JAX package ``gsv_tts_tpu`` and the repository's ``tools/``
(the TPU probes), as the machine with the card has none of them."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# run in a subprocess: this test process has imported JAX already
GUARD = r'''
import importlib, importlib.abc, pkgutil, sys

REFUSED = ("jax", "jaxlib", "optax", "gsv_tts_tpu", "tools")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, Refuse())
import gsv_tts_tpu_torch

names = [m.name for m in pkgutil.walk_packages(gsv_tts_tpu_torch.__path__, "gsv_tts_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print(len(names), leaked)
'''


def test_every_port_module_imports_without_jax_or_the_tpu_package():
    r = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    count, leaked = r.stdout.split(" ", 1)
    assert leaked.strip() == "[]"
    # the probes' package and the kernels' wrappers are among the modules walked
    assert int(count) >= 40



# the card's host has no aiohttp, aiortc, av or soundfile either: every module of the port
# but the router (pure HTTP, a verbatim copy of JAX's) imports without them, so the smoke
# can drive the serving layer's route methods there
GUARD_SERVING = GUARD.replace(
    '"gsv_tts_tpu", "tools")', '"gsv_tts_tpu", "tools", "aiohttp", "aiortc", "av", "soundfile")'
).replace("for name in names:", "for name in set(names) - {'gsv_tts_tpu_torch.serving.router'}:")


def test_every_port_module_but_the_router_imports_without_aiohttp():
    assert '"aiohttp", "aiortc", "av", "soundfile")' in GUARD_SERVING
    assert "- {'gsv_tts_tpu_torch.serving.router'}" in GUARD_SERVING
    r = subprocess.run([sys.executable, "-c", GUARD_SERVING], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    count, leaked = r.stdout.split(" ", 1)
    assert leaked.strip() == "[]"
    serving = {p.stem for p in (ROOT / "gsv_tts_tpu_torch" / "serving").glob("*.py")}
    assert serving == {"__init__", "asr", "batcher", "fleet", "openai_compat", "realtime",
                       "router", "server", "webui"}
    assert int(count) >= 50 and (ROOT / "gsv_tts_tpu_torch" / "fx.py").is_file()
