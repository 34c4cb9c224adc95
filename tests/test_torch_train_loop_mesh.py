"""The port's fine-tuning loops over meshes (``train_loop.finetune_t2s(mesh=,
pp_n_micro=, export_config=)``, ``finetune_sovits(mesh=)``) in gloo worlds of
4 and 2 CPU processes, against the port's single-process runs of the same
loops, and ``export_config`` against the JAX package's writer.

The sharded runs differ from the single run by the order of sums only, which
AdamW's ``g/(√v+ε)`` and the GAN's two phases amplify at isolated elements:
they are held in ``tests/test_train_loop.py``'s bulk form (at most 1e-3 of
a tensor's elements outside 5e-5 + 5e-4·|x|, none outside ten times that).
The k block of each layer's ``qkv_b`` is left out of the t2s comparison: its
gradient is zero in exact arithmetic (a shift common to every key leaves
the softmax unchanged), so each run moves it by AdamW's normalization of its
own rounding noise.  A resumed pipeline run equals its straight run
exactly."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from test_torch_assets import one_torch_thread  # noqa: F401

from gsv_tts_tpu import loader as jloader
from gsv_tts_tpu_torch import train_loop
from gsv_tts_tpu_torch.hparams import HParams
from gsv_tts_tpu_torch.models import sovits as psv
from gsv_tts_tpu_torch.models import t2s as pt2s
from gsv_tts_tpu_torch.parallel.launch import spawn
from gsv_tts_tpu_torch.parallel.mesh import free_port
from gsv_tts_tpu_torch.parallel.train import t2s_leaves

CFG = pt2s.T2SConfig(hidden_dim=64, embedding_dim=64, num_heads=4, num_layers=2,
                     vocab_size=101, phoneme_vocab_size=64, eos=100)
T2S_KW = dict(total_steps=4, batch_size=4, peak_lr=1e-3, warmup_steps=2, ckpt_every=100,
              log_every=100, seed=3)
EXPORT_CONFIG = {"model": {**CFG.to_checkpoint_config()["model"], "dropout": 0},
                 "data": {"max_sec": 54}}
SOVITS = psv.SovitsConfig(
    spec_channels=129, inter_channels=64, hidden_channels=64, filter_channels=96, n_heads=2,
    n_layers=2, kernel_size=3, p_dropout=0.0, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3, 5),), upsample_rates=(2, 2), upsample_initial_channel=32,
    upsample_kernel_sizes=(4, 4), gin_channels=512, ref_enc_in=96, flow_n_layers=2)
HPS = {"data": {"hop_length": 4, "filter_length": 16, "win_length": 16,
                "sampling_rate": 16000}, "train": {"segment_size": 32}}
SOVITS_KW = dict(total_steps=2, batch_size=4, segment_frames=4, ckpt_every=100, log_every=100)


def t2s_samples(n=12, seed=0):
    """Ragged (x, y, bert) samples; every third carries BERT features."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lx, ly = int(rng.randint(5, 11)), int(rng.randint(6, 13))
        bert = rng.randn(lx, 1024).astype(np.float32) * 0.1 if i % 3 == 0 else None
        out.append((rng.randint(1, 64, lx).astype(np.int32),
                    rng.randint(0, 100, ly).astype(np.int32), bert))
    return out


def sovits_samples(n=8, seed=1):
    """``tests/test_train_loop.py``'s ``make_sovits_samples``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        T = int(rng.randint(20, 33))
        out.append((rng.randn(768, T).astype(np.float32) * 0.1,
                    np.abs(rng.randn(SOVITS.spec_channels, T)).astype(np.float32),
                    (rng.randn(T * 4) * 0.1).astype(np.float32),
                    rng.randint(1, 100, size=(9,)).astype(np.int32)))
    return out


def assert_bulk_close(got, want, what):
    """``tests/test_train_loop.py``'s bound for sharded against single runs."""
    for k in want:
        a, b = np.asarray(want[k], np.float64), np.asarray(got[k], np.float64)
        tol = 5e-5 + 5e-4 * np.abs(b)
        diff = np.abs(a - b)
        assert float((diff > tol).mean()) <= 1e-3, (what, k)
        assert (diff <= 10 * tol).all(), (what, k, float((diff / tol).max()))


def without_k_bias(leaves):
    """The t2s leaves with each ``qkv_b``'s k block taken out."""
    D = CFG.hidden_dim
    return {k: np.concatenate([v[:D], v[2 * D:]]) if k.endswith("qkv_b") else v
            for k, v in leaves.items()}


def numpy_of(tree):
    return {k: v.detach().float().numpy() for k, v in tree.items()}


@pytest.fixture(scope="module")
def t2s_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("t2s")
    params = pt2s.init_params(CFG, torch.Generator().manual_seed(11))
    sd = {k: v.numpy() for k, v in pt2s.params_to_torch_state_dict(params, CFG).items()}
    single = train_loop.finetune_t2s(
        t2s_samples(), CFG, str(root / "single"), init_params=params, device="cpu",
        dtype=torch.float32, export_config=EXPORT_CONFIG, log_fn=lambda *_: None, **T2S_KW)
    world = spawn(workers.finetune_t2s_runs, 4, sd, dataclasses.asdict(CFG), t2s_samples(),
                  str(root), dict(T2S_KW, export_config=EXPORT_CONFIG), timeout=600)[0]
    return root, numpy_of(t2s_leaves(single)), world


@pytest.fixture(scope="module")
def sovits_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sovits")
    params = psv.init_params(SOVITS, torch.Generator().manual_seed(0))
    single = train_loop.finetune_sovits(
        sovits_samples(), SOVITS, HParams(HPS), str(root / "single"), init_params=params,
        device="cpu", export=False, log_fn=lambda *_: None, **SOVITS_KW)
    world = spawn(workers.finetune_sovits_runs, 2, {k: v.numpy() for k, v in params.items()},
                  dataclasses.asdict(SOVITS), HPS, sovits_samples(), str(root), SOVITS_KW,
                  timeout=600)[0]
    return numpy_of(single), world


def test_finetune_t2s_dp_tp_matches_single_run(t2s_runs):
    """dp=2×tp=2: the same 4 AdamW steps as one process, in bulk; rank 0
    exported the whole model with ``export_config``."""
    root, single, world = t2s_runs
    assert_bulk_close(without_k_bias(world["tp"]), without_k_bias(single), "dp2tp2")
    assert json.loads((root / "tp" / "config.json").read_text()) == EXPORT_CONFIG
    assert (root / "tp" / "model.safetensors").exists()


def test_finetune_t2s_pipeline_resume_equals_straight(t2s_runs):
    """dp=2×pp=2 GPipe, 2 microbatches: interrupted at step 2 (mid-epoch)
    and resumed from the gathered checkpoint equals the straight run
    exactly; the straight run follows the single run in bulk (the ragged
    epoch tail is dropped under pp, and 12 samples make whole batches)."""
    _, single, world = t2s_runs
    for k in world["pp_straight"]:
        assert np.array_equal(world["pp_straight"][k], world["pp_resumed"][k]), k
    assert_bulk_close(without_k_bias(world["pp_straight"]), without_k_bias(single), "dp2pp2")


def test_finetune_t2s_pipeline_rejects_bad_batches(t2s_runs):
    """JAX's errors: a batch that does not divide dp·n_micro, and fewer
    samples than one batch."""
    bad_divide, too_few = t2s_runs[2]["errors"]
    assert "must divide dp(2) * n_micro(4)" in bad_divide
    assert "needs >= one full batch" in too_few


def test_export_config_written_as_jax_writes_it(t2s_runs, tmp_path):
    """``finetune_t2s(export_config=)`` reaches ``save_trained_gpt(config=)``:
    the port's ``config.json`` is what JAX's ``save_trained_gpt`` writes for
    the same config."""
    root = t2s_runs[0]
    import jax

    from gsv_tts_tpu.models import t2s as jt2s

    jcfg = jt2s.T2SConfig(**dataclasses.asdict(CFG))
    jparams = jt2s.init_params(jax.random.PRNGKey(0), jcfg)
    jloader.save_trained_gpt(jparams, jcfg, str(tmp_path), config=EXPORT_CONFIG)
    assert (root / "single" / "config.json").read_text() == \
        (tmp_path / "config.json").read_text()


def test_finetune_sovits_dp_matches_single_run(sovits_runs):
    """dp=2: the batch's rows and the step's draws split over 2 ranks, G and
    D replicated, the losses' denominators global: 2 GAN steps as one
    process, in JAX's bulk form."""
    single, world = sovits_runs
    assert set(world["params"]) == set(single)
    assert_bulk_close(world["params"], single, "sovits dp2")


def test_finetune_sovits_rejects_indivisible_batch(sovits_runs):
    assert "must divide by the mesh dp extent 2" in sovits_runs[1]["error"]


def test_example_trains_under_torchrun_on_the_cpu(tmp_path):
    """``torchrun --nproc-per-node 2 examples/finetune_t2s_torch.py --pp 2 --n-micro 2
    --device cpu``: a GPipe run of two stages over gloo from a sample cache; rank 0 alone
    logs and exports a checkpoint the port loads."""
    from gsv_tts_tpu_torch import train_data
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_gpt_weights, save_trained_gpt

    repo = Path(__file__).resolve().parents[1]
    save_trained_gpt(pt2s.init_params(CFG, torch.Generator().manual_seed(5)), CFG,
                     str(tmp_path / "gpt"))
    train_data.save_samples(str(tmp_path / "samples.npz"), t2s_samples(8))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-port", str(free_port()),
           str(repo / "examples" / "finetune_t2s_torch.py"), "--device", "cpu",
           "--manifest", "unused.list", "--gpt", str(tmp_path / "gpt"), "--sovits", "unused",
           "--out-dir", str(tmp_path / "out"), "--cache", str(tmp_path / "samples.npz"),
           "--steps", "2", "--batch-size", "4", "--warmup", "1", "--pp", "2",
           "--n-micro", "2"]
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("step      1  loss") == 1, r.stdout  # rank 0's log only
    assert "mesh {'dp': 1, 'pp': 2}" in r.stdout
    gpt = get_gpt_weights(str(tmp_path / "out"), Config(device="cpu", gpt_cache=[(1, 64)]))
    assert gpt.cfg == CFG
