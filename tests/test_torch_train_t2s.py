"""The port's t2s training step (``gsv_tts_tpu_torch/parallel/train.py``)
against the JAX package's (``gsv_tts_tpu/parallel/train.py``) at a tiny
width: the same params (``convert.t2s_from_jax``, gradients through the same
function), the same batches, float32.

Tolerance: rtol 2e-4, atol 2e-5 (float32, summation order only) unless a
test says otherwise.  The sine table ``pe`` is a constant in the port (a
buffer in the reference); the JAX side here closes over it rather than
differentiating it, so both train the same leaves."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gsv_tts_tpu.models import t2s as jt2s
from gsv_tts_tpu.parallel import train as jtrain
from gsv_tts_tpu_torch import convert
from gsv_tts_tpu_torch.parallel import train as ptrain
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
CFG = jt2s.T2SConfig(hidden_dim=64, embedding_dim=64, num_heads=4, num_layers=2,
                     vocab_size=101, phoneme_vocab_size=64, eos=100)


def make_samples(seed=0, n=3):
    """Ragged samples; the first carries BERT features, the others none."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lx, ly = int(rng.randint(5, 11)), int(rng.randint(6, 13))
        bert = rng.randn(lx, 1024).astype(np.float32) * 0.1 if i == 0 else None
        out.append((rng.randint(1, 64, lx).astype(np.int32),
                    rng.randint(0, 100, ly).astype(np.int32), bert))
    return out


def jax_loss_fn(pe, batch, remat=False):
    """JAX's ``t2s_loss`` in float32 over every leaf but ``pe``."""
    def loss(p):
        return jtrain.t2s_loss({**p, "pe": pe}, CFG, batch["x_ids"], batch["y_ids"],
                               batch["bert"], batch["x_lens"], batch["y_lens"], jnp.float32,
                               remat=remat)
    return jax.jit(jax.value_and_grad(loss))


def port_params(jparams):
    return ptrain.t2s_train_params(convert.t2s_from_jax(jax.tree.map(np.asarray, jparams), CFG))


def port_view(jtree, pe):
    """A JAX params-shaped tree (params or gradients) as the port's named leaves."""
    return ptrain.t2s_leaves(convert.t2s_from_jax(jax.tree.map(np.asarray, {**jtree, "pe": pe}),
                                                  CFG))


def assert_leaves_close(want, got, rtol=RTOL, atol=ATOL, skip=()):
    assert list(want) == list(got)
    for name in want:
        w = want[name].detach().numpy()
        g = got[name].detach().numpy()
        if name in skip:
            w, g = skip[name](w), skip[name](g)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def setup():
    jp = jt2s.init_params(jax.random.PRNGKey(3), CFG, dtype=jnp.float32)
    pe = jp["pe"]
    trained = {k: v for k, v in jp.items() if k != "pe"}
    samples = make_samples()
    jb = jtrain.pad_batch(CFG, samples)
    pb = ptrain.pad_batch(CFG, samples)
    return dict(jp=trained, pe=pe, samples=samples, jb=jb, pb=pb)


def test_pad_batch_matches_jax(setup):
    jb, pb = setup["jb"], setup["pb"]
    assert set(jb) == set(pb)
    for k in jb:
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    assert pb["x_ids"].shape[1] % 32 == 0 and pb["y_ids"].shape[1] % 32 == 0
    # a wider pad multiple and a longer sample keep JAX's layout too
    samples = setup["samples"] + [(np.arange(1, 40, dtype=np.int32),
                                   np.arange(70, dtype=np.int32), None)]
    jb = jtrain.pad_batch(CFG, samples, pad_multiple=16)
    pb = ptrain.pad_batch(CFG, samples, pad_multiple=16)
    for k in jb:
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]), err_msg=k)


@pytest.mark.parametrize("remat", [False, True])
def test_t2s_loss_and_every_gradient_match_jax(setup, remat):
    """The loss and the gradient of every trained leaf, with and without
    rematerialization (``torch.utils.checkpoint`` / ``jax.checkpoint``)."""
    loss, grads = jax_loss_fn(setup["pe"], setup["jb"], remat)(setup["jp"])
    pp = port_params(setup["jp"])
    pb = setup["pb"]
    ploss = ptrain.t2s_loss(pp, CFG, pb["x_ids"], pb["y_ids"], pb["bert"], pb["x_lens"],
                            pb["y_lens"], torch.float32, remat=remat)
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=RTOL)
    leaves = ptrain.t2s_leaves(pp)
    pgrads = dict(zip(leaves, torch.autograd.grad(ploss, list(leaves.values()))))
    assert_leaves_close(port_view(grads, setup["pe"]), pgrads)
    assert all(g.abs().max() > 0 for k, g in pgrads.items() if "ln" not in k)


def test_lr_schedule_matches_optax():
    """``warmup_cosine_schedule`` is optax's at every step, the first update
    at lr 0 and ``decay_steps`` counting the warmup; the optimizer applies
    ``schedule(k)`` at update k, also after a resume."""
    for warmup, decay, total in ((3, 10, 13), (0, 6, 8), (4, 5, 7)):
        want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, decay, 1e-4)
        got = ptrain.warmup_cosine_schedule(1e-3, warmup, decay, 1e-4)
        for k in range(total):
            np.testing.assert_allclose(got(k), float(want(k)), rtol=1e-6, atol=1e-12)
    w = torch.zeros(3, requires_grad=True)
    opt, schedule = ptrain.make_optimizer({"w": w}, peak_lr=1e-3, warmup_steps=3,
                                          decay_steps=10)
    applied = []
    for _ in range(6):
        applied.append(opt.adamw.param_groups[0]["lr"])
        opt.update((w * torch.arange(3.0)).sum())
    assert applied == [schedule(k) for k in range(6)] and applied[0] == 0.0
    opt.resume(4)
    assert opt.adamw.param_groups[0]["lr"] == schedule(4)


@pytest.mark.parametrize("recipe", ["t2s", "sovits"])
def test_adamw_with_clipping_matches_optax(setup, recipe):
    """Three updates from the same gradients (JAX's, at JAX's params each
    step, with the global norm above the clip): the port's AdamW, clip and
    schedule give optax's params.  ``t2s``: ``make_optimizer``'s recipe (b2
    0.95, weight decay 0.01, warmup-cosine); ``sovits``: ``chain(
    clip_by_global_norm(1.0), adamw(lr))`` with optax's defaults, which
    ``Optimizer``'s defaults are (torch's own AdamW default weight decay is
    1e-2, not 1e-4)."""
    pe = setup["pe"]
    grad_fn = jax_loss_fn(pe, setup["jb"])
    jp = setup["jp"]
    if recipe == "t2s":
        jopt, _ = jtrain.make_optimizer(peak_lr=1e-2, warmup_steps=1, decay_steps=4,
                                        clip_norm=0.5)
    else:
        jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-2))
    jstate = jopt.init(jp)
    pp = port_params(jp)
    leaves = ptrain.t2s_leaves(pp)
    if recipe == "t2s":
        popt, _ = ptrain.make_optimizer(leaves, peak_lr=1e-2, warmup_steps=1, decay_steps=4,
                                        clip_norm=0.5)
    else:
        popt = ptrain.Optimizer(leaves, lambda _: 1e-2)
    for _ in range(3):
        _, grads = grad_fn(jp)
        norm = float(optax.global_norm(grads))
        assert norm > (0.5 if recipe == "t2s" else 1.0)  # the clip is active
        g = port_view(grads, pe)
        popt.update(sum((p * g[k]).sum() for k, p in leaves.items()))  # d/dp = g
        updates, jstate = jopt.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
    assert_leaves_close(port_view(jp, pe), leaves)


def test_train_step_matches_jax(setup):
    """Three full steps (loss, gradients, clip, AdamW, schedule): the same
    loss at each step, the same params after.  Adam divides each gradient
    element by its own magnitude, so an element whose gradient is near zero
    (|g| ~ eps) moves by up to lr times the relative rounding difference of
    g: at lr 1e-3 that stays inside the tolerance.  The key third of each
    ``qkv_b`` is left out of the final comparison: softmax does not see a
    bias on the keys, so its true gradient is zero, and Adam scales the
    ~1e-9 rounding noise both sides leave there up to a step of ±lr, of
    either sign."""
    pe = setup["pe"]
    grad_fn = jax_loss_fn(pe, setup["jb"])
    jopt, _ = jtrain.make_optimizer(peak_lr=1e-3, warmup_steps=1, decay_steps=4, clip_norm=0.5)
    jp = setup["jp"]
    jstate = jopt.init(jp)
    pp = port_params(jp)
    popt, _ = ptrain.make_optimizer(ptrain.t2s_leaves(pp), peak_lr=1e-3, warmup_steps=1,
                                    decay_steps=4, clip_norm=0.5)
    step = ptrain.make_train_step(CFG, popt, dtype=torch.float32)
    for _ in range(3):
        loss, grads = grad_fn(jp)
        np.testing.assert_allclose(float(step(pp, setup["pb"])), float(loss), rtol=RTOL)
        updates, jstate = jopt.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
    D = CFG.hidden_dim
    no_key_bias = {f"layers.{i}.qkv_b": (lambda a: np.concatenate([a[:D], a[2 * D:]]))
                   for i in range(CFG.num_layers)}
    assert_leaves_close(port_view(jp, pe), ptrain.t2s_leaves(pp), skip=no_key_bias)
