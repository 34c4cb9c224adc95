"""The port's GPipe step (``gsv_tts_tpu_torch/parallel/pipeline.py``) in a gloo
world of 4 CPU processes against the JAX package's dense single-device step
— the cases of ``tests/test_pipeline.py`` at 4 ranks: the microbatch
schedule, the stage-to-stage sends and the backward in reverse are an
execution order, not a change of numerics.

One clipped-SGD step at rate 1 (the clip acts), so a leaf's change is its
clipped gradient; ``pe`` is a constant on both sides.  Tolerance: 2e-5
absolute on the loss and on every updated leaf (float32, JAX's bound)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_parallel_workers as workers
from test_torch_assets import one_torch_thread  # noqa: F401
from test_torch_parallel import jax_step, state_dict_np

from gsv_tts_tpu.models import t2s as jt2s
from gsv_tts_tpu_torch.parallel.launch import spawn

CFG = jt2s.T2SConfig(hidden_dim=64, embedding_dim=64, num_heads=4, num_layers=8,
                     vocab_size=101, phoneme_vocab_size=64, eos=100)
TOL = 2e-5
#: (dp, pp, n_micro, remat, batch): JAX's three layouts at 4 ranks, remat,
#: n_micro 4 against 2, and the batch with 6 more padding columns of y
CASES = [(2, 2, 2, False, "base"), (1, 4, 4, False, "base"), (4, 1, 2, False, "base"),
         (2, 2, 2, True, "base"), (2, 2, 4, False, "base"), (2, 2, 2, False, "padded")]


def batch_np(B=8, Lx=8, Ly=12, seed=0):
    """``tests/test_pipeline.py``'s ``_batch``."""
    rng = np.random.RandomState(seed)
    return {"x_ids": rng.randint(1, 64, (B, Lx)).astype(np.int64),
            "y_ids": rng.randint(0, 100, (B, Ly)).astype(np.int64),
            "bert": (rng.randn(B, Lx, CFG.bert_dim) * 0.02).astype(np.float32),
            "x_lens": rng.randint(4, Lx + 1, (B,)).astype(np.int64),
            "y_lens": rng.randint(4, Ly + 1, (B,)).astype(np.int64)}


@pytest.fixture(scope="module")
def oracle():
    jp = jt2s.init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    base = batch_np()
    padded = dict(base, y_ids=np.concatenate([base["y_ids"], np.zeros((8, 6), np.int64)], 1))
    batches = {"base": base, "padded": padded}
    results = spawn(workers.pp_steps, 4, state_dict_np(jp, CFG), dataclasses.asdict(CFG),
                    batches, CASES, 0.5, timeout=600)
    want = jax_step(jp, base, cfg=CFG)
    return want, {case: (loss, results[0][i][1], [r[i][0] for r in results])
                  for i, (case, (loss, _)) in enumerate(zip(CASES, results[0]))}


def assert_close(got, want):
    (want_loss, want_leaves), (loss, leaves, losses) = want, got
    assert abs(loss - want_loss) < TOL
    assert losses == [loss] * len(losses)  # the whole batch's loss on every rank
    assert list(leaves) == list(want_leaves)
    worst = {k: float(np.abs(leaves[k] - want_leaves[k]).max()) for k in leaves}
    assert max(worst.values()) < TOL, worst


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: f"dp{c[0]}-pp{c[1]}-micro{c[2]}")
def test_pp_matches_single_device(oracle, case):
    want, got = oracle
    assert_close(got[case], want)


def test_pp_remat_matches(oracle):
    want, got = oracle
    assert_close(got[CASES[3]], want)


def test_pp_microbatch_count_invariant(oracle):
    """n_micro is a schedule knob: 4 microbatches give 2's gradients."""
    want, got = oracle
    assert_close(got[CASES[4]], want)
    a, b = got[CASES[0]][1], got[CASES[4]][1]
    assert max(float(np.abs(a[k] - b[k]).max()) for k in a) < TOL


def test_pp_ragged_lengths_masked(oracle):
    """Lengthening the y padding changes neither the loss nor the step."""
    want, got = oracle
    assert_close(got[CASES[5]], want)
