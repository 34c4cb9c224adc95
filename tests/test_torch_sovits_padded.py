"""The port's bucket-padded SoVITS slice against the JAX package, on the tiny
hyperparameters of ``test_torch_assets`` (float32, CPU): ``interpolate_linear``
and ``decode_core``'s speed change, the masked text encoder with a shape-padded
null key, the padded core one row at a time and batched, the whole fused
streaming chunk, and the facade's flow-bucket ladder.  Every length of the
padded core is a device tensor, and its valid region equals the port's own
exact-shape ``decode_core``.

Tolerance: rtol=2e-4, atol=2e-5 — float32 on both sides, summation order
only."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_sovits import models  # noqa: F401  (module-scoped fixture)
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def inputs(cfg, n, N, seed, frames=None, ge_frames=1):
    """Codes [1, 1, n], phones [1, N], ge [1, gin, ge_frames] and noise
    [1, inter, frames] from one numpy seed."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 1024, size=(1, 1, n)).astype(np.int32)
    text = rng.randint(1, 700, size=(1, N)).astype(np.int32)
    ge = (rng.randn(1, cfg.gin_channels, ge_frames) * 0.5).astype(np.float32)
    noise = (rng.randn(1, cfg.inter_channels, frames or 2 * n) * 0.5).astype(np.float32)
    return codes, text, ge, noise


def padded(a, width):
    out = np.zeros(a.shape[:-1] + (width,), a.dtype)
    out[..., :a.shape[-1]] = a
    return out


@pytest.mark.parametrize("t,size", [(37, 61), (37, 20), (50, 63), (50, 41), (8, 8), (101, 127)])
def test_interpolate_linear_matches_jax(t, size):
    """The half-pixel positions and weights of JAX's ``interpolate_linear``,
    up- and down-sampling (the speed change's ``int(t / speed) + 1``)."""
    from gsv_tts_tpu.ops.convs import interpolate_linear as jinterp
    from gsv_tts_tpu_torch.ops.convs import interpolate_linear as pinterp

    x = np.random.RandomState(t + size).randn(2, 16, t).astype(np.float32)
    got = pinterp(torch.tensor(x), size)
    assert got.shape == (2, 16, size)
    close(got, jinterp(jnp.asarray(x), size))


@pytest.mark.parametrize("speed,packed", [(0.8, False), (1.25, False), (1.25, True)],
                         ids=["0.8", "1.25", "1.25-packed"])
def test_decode_core_speed_matches_jax(models, speed, packed):  # noqa: F811
    """``decode_core(speed)``: the latent resampled linearly, the mask (and
    a packed batch's frame-wise ``ge``) nearest, ``z_p`` at
    ``int(2n / speed) + 1`` frames."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    n, N = 23, 17
    frames = int(2 * n / speed) + 1
    codes, text, ge, noise = inputs(jcfg, n, N, 3, frames, n if packed else 1)
    si = None
    if packed:  # two requests: codes 0..9 read phones 0..6, the rest 7..16
        si = np.repeat(np.asarray([[0, 7], [7, N]], np.int32), [20, 2 * n - 20], axis=0)
    jz, jmask, jattn, _, jge = jax.jit(
        lambda p, c, t, g, nz, s: js.decode_core(p, jcfg, c, t, g, nz, speed=speed,
                                                 slice_indices=s))(
        jp, jnp.asarray(codes), jnp.asarray(text), jnp.asarray(ge), jnp.asarray(noise),
        None if si is None else jnp.asarray(si))
    pz, pmask, pattn, pov, pge = ps.decode_core(
        pp, pcfg, torch.tensor(codes), torch.tensor(text), torch.tensor(ge),
        torch.tensor(noise), speed=speed,
        slice_indices=None if si is None else torch.tensor(si, dtype=torch.int64))
    assert pz.shape == (1, jcfg.inter_channels, frames) and pov is None
    assert pge.shape == tuple(jge.shape) == (1, 512, frames if packed else 1)
    close(pz, jz, "z_p")
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    close(pattn, jattn, "attn")
    close(pge, jge, "ge")


def test_text_encoder_masks_and_null_key_match_jax(models):  # noqa: F811
    """``text_encoder_infer`` with padded frames and phones masked, and the
    packed form with the null key at a column that is not the last."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    rng = np.random.RandomState(4)
    T, N = 40, 19
    y = rng.randn(1, 768, T).astype(np.float32)
    text = rng.randint(1, 700, size=(1, N)).astype(np.int32)
    ge = (rng.randn(1, 512, 1) * 0.5).astype(np.float32)
    y_mask = (np.arange(T) < 31).astype(np.float32)[None, None]
    text_mask = (np.arange(N) < 15).astype(np.float32)[None, None]
    si = np.repeat(np.asarray([[0, 6], [6, 14]], np.int32), [18, T - 18], axis=0)
    for kw in (dict(y_mask=y_mask, text_mask=text_mask),
               dict(slice_indices=si, nullkey_idx=np.int32(14))):
        jh, jm, ja = js.text_encoder_infer(
            jp, jcfg, jnp.asarray(y), jnp.asarray(text), jnp.asarray(ge),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        ph, pm, pa = ps.text_encoder_infer(
            pp, pcfg, torch.tensor(y), torch.tensor(text), torch.tensor(ge),
            **{k: torch.tensor(v).long() if v.dtype.kind == "i" else torch.tensor(v)
               for k, v in kw.items()})
        assert torch.isfinite(pa).all()  # a fully masked row is uniform, not NaN
        close(ph, jh, f"latent {sorted(kw)}")
        close(pa, ja, f"attn {sorted(kw)}")
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


#: (codes n, phones N, vsi, blend, overlap): first chunks, blended later ones,
#: in the 32- and 64-frame buckets
PADDED_CASES = [(20, 13, 0, False, 5), (29, 30, 16, True, 5), (45, 40, 30, True, 3),
                (33, 13, 50, True, 5), (50, 64, 0, False, 1)]


@pytest.mark.parametrize("n,N,vsi,blend,ov", PADDED_CASES)
def test_decode_core_stream_padded_matches_jax_and_exact(models, n, N, vsi, blend,  # noqa: F811
                                                        ov):
    """The padded core with 0-dim device lengths: ``z_p``, the mask, the valid
    block of ``attn`` and the new overlap equal JAX's padded core, and its
    valid region equals the port's exact ``decode_core`` on the same chunk."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    Bc, Np = -(-n // 32) * 32, -(-N // 32) * 32
    codes, text, ge, noise = inputs(jcfg, n, N, 5 + n, 2 * Bc)
    y_ov = (np.random.RandomState(n).randn(1, jcfg.hidden_channels, ov) * 0.5
            ).astype(np.float32)
    cp, tp = padded(codes, Bc), padded(text, Np)
    jout = jax.jit(lambda p, c, cl, t, tl, g, nz, yo, v: js.decode_core_stream_padded(
        p, jcfg, c, cl, t, tl, g, nz, yo, v, overlap_len=ov, blend=blend))(
        jp, jnp.asarray(cp), jnp.int32(n), jnp.asarray(tp), jnp.int32(N), jnp.asarray(ge),
        jnp.asarray(noise), jnp.asarray(y_ov), jnp.int32(vsi))
    i64 = torch.int64
    pout = ps.decode_core_stream_padded(
        pp, pcfg, torch.tensor(cp), torch.tensor(n, dtype=i64), torch.tensor(tp),
        torch.tensor(N, dtype=i64), torch.tensor(ge), torch.tensor(noise), torch.tensor(y_ov),
        torch.tensor(vsi, dtype=i64), overlap_len=ov, blend=blend)
    (pz, pmask, pattn, pnew), (jz, jmask, jattn, jnew) = pout, jout
    assert pz.shape == (1, jcfg.inter_channels, 2 * Bc) and pattn.shape == (1, 4, 2 * Bc, Np)
    close(pz, jz, "z_p")
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    close(pattn[..., :2 * n, :N], np.asarray(jattn)[..., :2 * n, :N], "attn")
    close(pnew, jnew, "new overlap")

    t_valid = 2 * n - vsi
    ez, emask, eattn, enew, _ = ps.decode_core(
        pp, pcfg, torch.tensor(codes), torch.tensor(text), torch.tensor(ge),
        torch.tensor(noise[:, :, :t_valid]), y_overlap=torch.tensor(y_ov) if blend else None,
        valid_start_idx=vsi, overlap_len=ov)
    close(pz[:, :, :t_valid], ez, "z_p vs exact")
    assert torch.equal(pmask[:, :, :t_valid], emask) and not pmask[:, :, t_valid:].any()
    close(pattn[..., :2 * n, :N], eattn, "attn vs exact")
    close(pnew, enew, "new overlap vs exact")


def test_decode_core_stream_padded_batch_rows_match_solo_rows(models):  # noqa: F811
    """Three rows at different lengths, offsets and blends in one bucket: each
    row of the batched core equals the row run alone, and JAX's batched core."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    Bc, Np, ov = 32, 32, 4
    rows = [(20, 13, 0, False), (29, 30, 16, True), (11, 7, 9, True)]
    ins = [inputs(jcfg, n, N, 40 + i, 2 * Bc) for i, (n, N, _, _) in enumerate(rows)]
    y_ov = (np.random.RandomState(7).randn(3, jcfg.hidden_channels, ov) * 0.5
            ).astype(np.float32)
    cp = np.concatenate([padded(c, Bc) for c, _, _, _ in ins])
    tp = np.concatenate([padded(t, Np) for _, t, _, _ in ins])
    ge = np.concatenate([g for _, _, g, _ in ins])
    noise = np.concatenate([nz for _, _, _, nz in ins])
    lens = [np.asarray([r[k] for r in rows]) for k in range(4)]
    i64 = torch.int64
    pb = ps.decode_core_stream_padded_batch(
        pp, pcfg, torch.tensor(cp), torch.tensor(lens[0], dtype=i64), torch.tensor(tp),
        torch.tensor(lens[1], dtype=i64), torch.tensor(ge), torch.tensor(noise),
        torch.tensor(y_ov), torch.tensor(lens[2], dtype=i64), torch.tensor(lens[3]),
        overlap_len=ov)
    jb = js.decode_core_stream_padded_batch(
        jp, jcfg, jnp.asarray(cp), jnp.asarray(lens[0], jnp.int32), jnp.asarray(tp),
        jnp.asarray(lens[1], jnp.int32), jnp.asarray(ge), jnp.asarray(noise),
        jnp.asarray(y_ov), jnp.asarray(lens[2], jnp.int32), jnp.asarray(lens[3]),
        overlap_len=ov)
    for b, (n, N, vsi, blend) in enumerate(rows):
        solo = ps.decode_core_stream_padded(
            pp, pcfg, torch.tensor(cp[b:b + 1]), torch.tensor(n, dtype=i64),
            torch.tensor(tp[b:b + 1]), torch.tensor(N, dtype=i64), torch.tensor(ge[b:b + 1]),
            torch.tensor(noise[b:b + 1]), torch.tensor(y_ov[b:b + 1]),
            torch.tensor(vsi, dtype=i64), overlap_len=ov, blend=blend)
        for k, (got, one, want) in enumerate(zip(pb, solo, jb)):
            got, one, want = got[b:b + 1], one, np.asarray(want)[b:b + 1]
            if k == 2:  # attention: the row's valid block
                got, one, want = (a[..., :2 * n, :N] for a in (got, one, want))
            close(got, one, f"row {b} output {k} vs solo")
            close(got, want, f"row {b} output {k} vs JAX")


@pytest.mark.parametrize("n,vsi,bucket", [(20, 0, 50), (29, 16, 128), (45, 30, 55)])
def test_stream_batch_fused_matches_jax(models, n, vsi, bucket):  # noqa: F811
    """The whole bucketed chunk at B=1 — padded core, the latent padded or
    cut to the flow bucket, flow⁻¹ and HiFi-GAN — equals JAX's fused
    program (audio, attention, new overlap)."""
    from gsv_tts_tpu.runtime.vocoder_batch import _stream_batch_fused_jit
    from gsv_tts_tpu_torch.runtime.vocoder_batch import stream_batch_fused

    jcfg, jp, pcfg, pp = models
    N, ov = 13, 5
    Bc, Np = -(-n // 32) * 32, 32
    codes, text, ge, noise = inputs(jcfg, n, N, 60 + n, 2 * Bc)
    y_ov = (np.random.RandomState(1).randn(1, jcfg.hidden_channels, ov) * 0.5
            ).astype(np.float32)
    blend = np.asarray([vsi > 0])
    args = [padded(codes, Bc), np.asarray([n]), padded(text, Np), np.asarray([N]), ge, noise,
            y_ov, np.asarray([vsi]), blend]
    ja, jattn, jov = _stream_batch_fused_jit(
        jp, jcfg, *[jnp.asarray(a, jnp.int32 if a.dtype.kind == "i" else None) for a in args],
        ov, bucket)
    pa, pattn, pov = stream_batch_fused(pp, pcfg, *[torch.tensor(a) for a in args],
                                        overlap_len=ov, bucket=bucket)
    assert pa.shape == tuple(ja.shape) == (1, 1, bucket * pcfg.samples_per_frame)
    close(pa, ja, "audio")
    close(pattn[..., :2 * n, :N], np.asarray(jattn)[..., :2 * n, :N], "attn")
    close(pov, jov, "new overlap")


@pytest.mark.parametrize("cache", [[50, 55], [55, 50], []], ids=["default", "unsorted", "exact"])
@pytest.mark.parametrize("use_buckets", [True, False])
def test_flow_bucket_matches_jax(tmp_path, cache, use_buckets):
    """``_flow_bucket`` for t in 1..400: the configured buckets, the ×1.5
    ladder rounded to 64 above them (alone under ``use_buckets=False``, the
    packed ``infer_batched``), exact when ``sovits_cache=[]``."""
    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    ptts = TTS(sovits_cache=cache, models_dir=str(tmp_path), device="cpu")
    jself = types.SimpleNamespace(tts_config=types.SimpleNamespace(
        sovits_cache=sorted(cache) if cache else []))
    got = [ptts._flow_bucket(t, use_buckets) for t in range(1, 401)]
    assert got == [JaxTTS._flow_bucket(jself, t, use_buckets) for t in range(1, 401)]
    assert all(b >= t for t, b in zip(range(1, 401), got))


def test_sovits_graphs_run_eagerly_on_the_cpu():
    """On CPU tensors the graph cache calls the function and captures nothing."""
    from gsv_tts_tpu_torch.tts import SovitsGraphs

    graphs = SovitsGraphs()
    x, params = torch.arange(4.0), {}
    assert graphs.run(params, ("k",), lambda a: a * 2, x)[0].tolist() == [0.0, 2.0, 4.0, 6.0]
    assert graphs.run(params, ("k",), lambda a, b: (a + b, a - b), x, x)[1].tolist() == [0.0] * 4
    assert graphs.captures == graphs.replays == 0 and not graphs.graphs and not graphs.pools
    with pytest.raises(ValueError, match="one device"):
        graphs.run(params, ("k",), lambda a, b: a + b, x, torch.zeros(4, device="meta"))
