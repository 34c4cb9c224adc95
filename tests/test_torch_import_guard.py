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



# the card's host has no aiohttp, aiortc, av, soundfile, sounddevice, requests or tqdm
# either: every module of the port but the router (pure HTTP, a verbatim copy of JAX's)
# imports without them, so the smoke can drive the serving layer's route methods, playback
# and the download manager's offline path there
GUARD_SERVING = GUARD.replace(
    '"gsv_tts_tpu", "tools")', '"gsv_tts_tpu", "tools", "aiohttp", "aiortc", "av", "soundfile", '
    '"sounddevice", "requests", "tqdm")'
).replace("for name in names:", "for name in set(names) - {'gsv_tts_tpu_torch.serving.router'}:")


def test_every_port_module_but_the_router_imports_without_aiohttp():
    assert '"aiohttp", "aiortc", "av", "soundfile", "sounddevice", "requests", "tqdm")' in \
        GUARD_SERVING
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
    assert {"player", "download"} <= {p.stem for p in (ROOT / "gsv_tts_tpu_torch").glob("*.py")}


# the multi-device modules run, not only import, with JAX refused: a world of one rank
# over gloo shards an engine, runs a DataParallelEngine, a dp×tp train step, a seq_mesh
# step and a GPipe step
GUARD_PARALLEL = GUARD.split("sys.meta_path.insert(0, Refuse())")[0] + r'''
sys.meta_path.insert(0, Refuse())
import numpy as np
import torch

from gsv_tts_tpu_torch.models import t2s
from gsv_tts_tpu_torch.parallel import launch, mesh as pmesh, pipeline as ppl, shard
from gsv_tts_tpu_torch.parallel import train as ptrain
from gsv_tts_tpu_torch.runtime.t2s_session import T2SEngine

cfg = t2s.T2SConfig(hidden_dim=32, embedding_dim=32, num_heads=2, num_layers=2)
params = t2s.init_params(cfg, torch.Generator().manual_seed(0))
mesh = pmesh.make_mesh(device="cpu")
x, y, b = np.arange(1, 9), np.arange(5), np.zeros((8, 1024), np.float32)
eng = T2SEngine(params, cfg, [(1, 96), (2, 96)]).shard(mesh)
toks = eng.generate(x, y, b, top_k=1, generator=torch.Generator().manual_seed(0))
dpe = shard.DataParallelEngine(params, cfg, [(1, 96), (2, 96)], mesh=mesh)
pred, _ = dpe.generate_batched([x, x], [y, y], [b, b], top_k=1,
                               generator=torch.Generator().manual_seed(0))
batch = ptrain.pad_batch(cfg, [(x, y + 1, None), (x[:5], y, None)])
losses = []
for kind in ("tp", "seq", "pp"):
    m = ppl.make_mesh_dp_pp(device="cpu") if kind == "pp" else mesh
    p = ptrain.t2s_train_params(params)
    if kind == "pp":
        p = ppl.shard_pp_params(p, cfg, m)
    names = list(ptrain.t2s_leaves(p))
    sync = ptrain.t2s_grad_sync(names, pp_mesh=m) if kind == "pp" else \
        ptrain.t2s_grad_sync(names, mesh=m, seq=kind == "seq")
    opt, _ = ptrain.make_optimizer(ptrain.t2s_leaves(p), sync=sync)
    step = ppl.make_pp_train_step(cfg, opt, m, 2, torch.float32) if kind == "pp" else \
        ptrain.make_train_step(cfg, opt, torch.float32, **{"seq_mesh" if kind == "seq" else "mesh": m})
    losses.append(float(step(p, batch)))
assert toks.size and len(pred) == 2 and all(np.isfinite(losses)), (toks, pred, losses)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print(len(losses), leaked)
'''


def test_multi_device_modules_run_without_jax():
    """``parallel/{mesh,shard,pipeline,launch,train}.py`` import and run in a world of
    one rank with JAX refused."""
    parallel = {p.stem for p in (ROOT / "gsv_tts_tpu_torch" / "parallel").glob("*.py")}
    assert {"mesh", "shard", "pipeline", "launch", "train"} <= parallel
    r = subprocess.run([sys.executable, "-c", GUARD_PARALLEL], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    count, leaked = r.stdout.strip().split("\n")[-1].split(" ", 1)
    assert count == "3" and leaked.strip() == "[]"
