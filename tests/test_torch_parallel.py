"""The port's multi-rank inference and training (``gsv_tts_tpu_torch/parallel/``:
``mesh.py``, ``shard.py``, ``train.py``; ``T2SEngine.shard``) in a gloo world
of 4 CPU processes, against the JAX package's single-device results — what
JAX's own tests (``tests/test_parallel.py``) hold its sharded paths to.

One world runs every multi-rank case of the module (``launch.spawn``, the
ranks' code in ``torch_parallel_workers.py``); the JAX oracles run here.

Tolerances: tokens equal at ``top_k=1``; the sampled dp engine equal to the
port's single engine over the first ``SAMPLED_PREFIX`` tokens of each
request (the local waves' products sum in another order); train steps: loss
rtol 1e-5, params rtol 1e-4, atol 2e-5 (float32, ``tests/test_parallel.py``'s
bounds)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_parallel_workers as workers
from test_torch_assets import one_torch_thread  # noqa: F401

from gsv_tts_tpu.models import t2s as jt2s
from gsv_tts_tpu.parallel import mesh as jmesh
from gsv_tts_tpu.parallel import pipeline as jpipe
from gsv_tts_tpu.parallel import train as jtrain
from gsv_tts_tpu.runtime.t2s_session import T2SEngine as JaxEngine
from gsv_tts_tpu_torch import convert
from gsv_tts_tpu_torch.models import t2s as pt2s
from gsv_tts_tpu_torch.parallel import mesh as pmesh
from gsv_tts_tpu_torch.parallel import pipeline as ppl
from gsv_tts_tpu_torch.parallel import train as ptrain
from gsv_tts_tpu_torch.parallel.launch import spawn
from gsv_tts_tpu_torch.runtime.t2s_session import T2SEngine

CFG = jt2s.T2SConfig(hidden_dim=64, embedding_dim=64, num_heads=4, num_layers=2,
                     vocab_size=101, phoneme_vocab_size=64, eos=100)
FIELDS = dataclasses.asdict(CFG)
SAMPLED_PREFIX = 20
CLIP = 0.5  # below the step's gradient norm: the clip acts


def state_dict_np(jparams, cfg=CFG):
    """JAX params → the port's runtime state dict as numpy (for the ranks)."""
    port = convert.t2s_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return {k: v.numpy() for k, v in pt2s.params_to_torch_state_dict(port, cfg).items()}


def prompts():
    """The five prompts of ``tests/test_parallel.py``."""
    rng = np.random.RandomState(7)
    xs, ys, bs = [], [], []
    for i in range(5):
        lx, ly = 6 + i % 3, 4 + i % 2
        xs.append(rng.randint(1, 64, (lx,)).astype(np.int32))
        ys.append(rng.randint(0, 100, (ly,)).astype(np.int32))
        bs.append(np.zeros((lx, CFG.bert_dim), np.float32))
    return xs, ys, bs


def batch_np(B, Lx=8, Ly=12, seed=0):
    """``tests/test_parallel.py``'s ``_batch``, with BERT features."""
    rng = np.random.RandomState(seed)
    return {"x_ids": rng.randint(1, 64, (B, Lx)).astype(np.int64),
            "y_ids": rng.randint(0, 100, (B, Ly)).astype(np.int64),
            "bert": (rng.randn(B, Lx, CFG.bert_dim) * 0.02).astype(np.float32),
            "x_lens": np.asarray([Lx - (i % 3) for i in range(B)], np.int64),
            "y_lens": np.asarray([Ly - (i % 2) for i in range(B)], np.int64)}


def jax_step(jp, batch, clip=CLIP, remat=False, cfg=CFG):
    """JAX's single-device step (``t2s_loss``) with optax's clip and SGD at
    rate 1, ``pe`` held constant as the port does: (loss, the port's view of
    the updated leaves)."""
    pe = jp["pe"]
    trained = {k: v for k, v in jp.items() if k != "pe"}
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else v.dtype)
          for k, v in batch.items()}

    def loss(p):
        return jtrain.t2s_loss({**p, "pe": pe}, cfg, jb["x_ids"], jb["y_ids"], jb["bert"],
                               jb["x_lens"], jb["y_lens"], jnp.float32, remat=remat)

    value, grads = jax.jit(jax.value_and_grad(loss))(trained)
    opt = optax.chain(optax.clip_by_global_norm(clip), optax.sgd(1.0))
    updates, _ = opt.update(grads, opt.init(trained), trained)
    new = optax.apply_updates(trained, updates)
    port = convert.t2s_from_jax(jax.tree.map(np.asarray, {**new, "pe": pe}), cfg)
    return float(value), {k: v.numpy() for k, v in ptrain.t2s_leaves(port).items()}


def assert_leaves_close(got, want, rtol=1e-4, atol=2e-5):
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jparams():
    return jt2s.init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)


@pytest.fixture(scope="module")
def world(jparams):
    """Every multi-rank case of the module, in one 4-rank gloo world."""
    return spawn(workers.parallel_world, 4, state_dict_np(jparams), FIELDS, prompts(),
                 batch_np(8), batch_np(4, Lx=16, Ly=16, seed=3), CLIP, timeout=600)


# ---------------------------------------------------------------------------
# The mesh rule (no world needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_factorization_matches_jax(n):
    """``mesh.factor`` / ``pipeline.factor_pp`` against JAX's ``make_mesh`` /
    ``make_mesh_dp_pp`` on n of the CPU devices, with no size and with each
    explicit pair; a pair that does not multiply to n raises in both."""
    assert pmesh.factor(n) == tuple(jmesh.make_mesh(n).devices.shape)
    assert ppl.factor_pp(n) == tuple(jpipe.make_mesh_dp_pp(n).devices.shape)
    for a in (1, 2, 4, 8):
        for got, want in ((pmesh.factor(n, dp=a) if n % a == 0 else None,
                           jmesh.make_mesh(n, dp=a) if n % a == 0 else None),
                          (pmesh.factor(n, tp=a) if n % a == 0 else None,
                           jmesh.make_mesh(n, tp=a) if n % a == 0 else None),
                          (ppl.factor_pp(n, pp=a) if n % a == 0 else None,
                           jpipe.make_mesh_dp_pp(n, pp=a) if n % a == 0 else None)):
            assert got == (None if want is None else tuple(want.devices.shape))
        for b in (1, 2, 4, 8):
            if a * b == n:
                assert pmesh.factor(n, dp=a, tp=b) == tuple(
                    jmesh.make_mesh(n, dp=a, tp=b).devices.shape)
            else:
                with pytest.raises(ValueError):
                    pmesh.factor(n, dp=a, tp=b)
                with pytest.raises(AssertionError):
                    jmesh.make_mesh(n, dp=a, tp=b)


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tokens(jparams):
    xs, ys, bs = prompts()

    def batched(cache):
        eng = JaxEngine(jparams, CFG, gpt_cache=cache, dtype=jnp.float32)
        pred, idx = eng.generate_batched(xs, ys, bs, top_k=1, rng=jax.random.PRNGKey(0))
        return eng, {int(i): np.asarray(t).tolist() for t, i in zip(pred, idx)}

    eng, tp_batched = batched([(1, 128), (4, 128)])
    one = np.asarray(eng.generate(xs[0], ys[0], bs[0], top_k=1,
                                  rng=jax.random.PRNGKey(5))).ravel().tolist()
    return {"one": one, "batched": tp_batched, "dp": batched([(1, 128), (8, 128)])[1]}


@pytest.mark.parametrize("layout", ["tp4", "dp2tp2"])
def test_sharded_engine_matches_jax_single_device(world, jax_tokens, layout):
    """``T2SEngine.shard`` at tp=4 and at dp=2×tp=2: ``generate`` and
    ``generate_batched`` tokens equal JAX's single-device engine at
    ``top_k=1`` on every rank; the engine takes the ``"xla"`` path with no
    kernel table and holds H/tp heads' rows."""
    tp = 4 if layout == "tp4" else 2
    for rank in world:
        one, batched, impl, qkv_shape, has_table = rank["engines"][layout]
        assert one == jax_tokens["one"]
        assert batched == jax_tokens["batched"]
        assert impl == "xla" and not has_table
        assert qkv_shape == (3 * CFG.hidden_dim // tp, CFG.hidden_dim)


def test_data_parallel_engine_matches_jax_and_single_engine(world, jax_tokens, jparams):
    """``DataParallelEngine`` at dp=4 (``[(1,128),(8,128)]``: two slots on
    each rank, K2's twin): greedy tokens equal JAX's single device; sampled
    (``top_k=15``, one seed) equal to the port's single engine under the same
    generator over the first ``SAMPLED_PREFIX`` tokens; every rank alike.  A
    bucket that does not divide over dp raises."""
    sd = state_dict_np(jparams)
    cfg = pt2s.T2SConfig(**FIELDS)
    xs, ys, bs = prompts()
    single = T2SEngine(pt2s.params_from_torch_state_dict(sd, cfg), cfg, [(1, 128), (8, 128)])
    pred, idx = single.generate_batched(xs, ys, bs, generator=torch.Generator().manual_seed(0))
    sampled = {int(i): p.tolist() for p, i in zip(pred, idx)}
    for rank in world:
        greedy, stats, _ = rank["engines"]["dp4"]
        assert greedy == jax_tokens["dp"]
        assert stats["k2_steps"] > 0 and stats["generic_steps"] == 0
        got, _ = rank["engines"]["dp4_sampled"]
        assert sorted(got) == sorted(sampled)
        for i in sampled:
            assert got[i][:SAMPLED_PREFIX] == sampled[i][:SAMPLED_PREFIX], i
        assert "not divisible by dp" in rank["engines"]["bad_bucket"]
    assert all(r["engines"]["dp4_sampled"][0] == world[0]["engines"]["dp4_sampled"][0]
               for r in world)


def test_quantized_engine_does_not_shard():
    """A quantized engine's ``shard`` raises (JAX's ``t2s_param_sharding``
    has no place for ``layers_q8``)."""
    cfg = pt2s.T2SConfig(hidden_dim=64, embedding_dim=64, num_heads=4, num_layers=1)
    params = pt2s.init_params(cfg, torch.Generator().manual_seed(0))
    eng = T2SEngine(params, cfg, [(1, 64)], attn_impl="fused_step_q8")
    with pytest.raises(ValueError, match="quantized"):
        eng.shard(None)


def test_layouts_round_trip():
    """``Split`` cuts q, k and v by head and gathers back (one rank's
    arithmetic, checked without a world)."""
    full = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(3 * 8, 2)
    cut = pmesh.Split.__new__(pmesh.Split)
    cut.group, cut.dim, cut.parts, cut.n = None, 0, 3, 4
    pieces = []
    for r in range(4):
        cut.rank = r
        pieces.append(cut.local(full))
    for r, piece in enumerate(pieces):  # q, k, v rows of head pair r
        want = torch.cat([full[p * 8 + 2 * r: p * 8 + 2 * r + 2] for p in range(3)])
        assert torch.equal(piece, want)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,remat", [("dp2tp2", False), ("dp2tp2_remat", True)])
def test_tp_dp_train_step_matches_jax(world, jparams, case, remat):
    """One step on a dp=2×tp=2 mesh (the batch's rows over dp, the layers by
    head over tp, the clip over the whole gradient) against JAX's
    single-device step: loss rtol 1e-5, updated params rtol 1e-4, atol 2e-5;
    every rank reports the whole batch's loss."""
    want_loss, want = jax_step(jparams, batch_np(8), remat=remat)
    loss, got = world[0]["train"][case]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert_leaves_close(got, want)
    for rank in world:
        assert rank["train"][case][0] == loss


def test_seq_parallel_train_step_matches_jax(world, jparams):
    """``make_train_step(seq_mesh=)``: the packed prompt's time axis split
    over tp, K/V all-gathered, params replicated — loss and updated params
    as JAX's unsharded step."""
    want_loss, want = jax_step(jparams, batch_np(4, Lx=16, Ly=16, seed=3))
    loss, got = world[0]["train"]["seq"]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert_leaves_close(got, want)
