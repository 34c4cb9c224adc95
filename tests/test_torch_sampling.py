"""The port's sampling ops (``ops/sampling.py``) and K1's twin sampler
(``ops/fused_step.filter_row_ref``) against the JAX package's
``ops/sampling.py`` (float32; rtol=2e-4, atol=2e-5: summation order only)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

RTOL, ATOL = 2e-4, 2e-5


@pytest.mark.parametrize("kw", [
    dict(temperature=1.0, top_k=15, top_p=1.0, repetition_penalty=1.35),
    dict(temperature=0.7, top_k=5, top_p=0.8, repetition_penalty=1.2),
    dict(temperature=1.3, top_k=1025, top_p=0.5, repetition_penalty=1.0),
    dict(temperature=1.0, top_k=1, top_p=1.0, repetition_penalty=1.35),
])
def test_logits_to_probs_matches_jax(kw):
    from gsv_tts_tpu.ops import sampling as js
    from gsv_tts_tpu_torch.ops import sampling as ps

    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 1025) * 2).astype(np.float32)
    prev = np.full((3, 40), 1025, np.int32)
    prev[:, :25] = rng.randint(0, 1025, size=(3, 25))
    jp = js.logits_to_probs(jnp.asarray(logits), jnp.asarray(prev), **kw)
    pp = ps.logits_to_probs(torch.tensor(logits), torch.tensor(prev), **kw)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)


def test_repetition_penalty_marks_token_zero_beside_empty_entries():
    """Token 0 in the history is penalised although the buffer's empty
    entries (id V) follow it: an empty entry must not clear a real mark."""
    from gsv_tts_tpu.ops import sampling as js
    from gsv_tts_tpu_torch.ops import sampling as ps

    logits = np.asarray([[2.0, -1.0, 0.5, 1.0]], np.float32)
    prev = np.asarray([[3, 0] + [4] * 30], np.int32)
    j = np.asarray(js.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(prev), 2.0))
    p = ps.apply_repetition_penalty(torch.tensor(logits), torch.tensor(prev), 2.0).numpy()
    np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(p, [[1.0, -1.0, 0.5, 0.5]])


def test_top_k_keeps_every_value_tied_with_the_kth():
    from gsv_tts_tpu.ops import sampling as js
    from gsv_tts_tpu_torch.ops import sampling as ps

    logits = np.asarray([[0.0, 3.0, 1.0, 3.0, 1.0, 1.0, -2.0, 2.0]], np.float32)
    for k in (1, 2, 3, 4, 5):
        j = np.isfinite(np.asarray(js.apply_top_k(jnp.asarray(logits), k)))
        p = torch.isfinite(ps.apply_top_k(torch.tensor(logits), k)).numpy()
        assert np.array_equal(p, j), k
    # k=4: the 4th largest is 1.0, so all three 1.0s survive
    assert torch.isfinite(ps.apply_top_k(torch.tensor(logits), 4)).sum() == 6


def test_gumbel_argmax_ties_go_to_the_lowest_id():
    from gsv_tts_tpu.ops import sampling as js
    from gsv_tts_tpu_torch.ops import sampling as ps

    probs = np.asarray([[0.1, 0.3, 0.1, 0.3, 0.2], [0.25, 0.25, 0.0, 0.25, 0.25]], np.float32)
    g = np.zeros_like(probs)
    p = ps.gumbel_argmax_with_noise(torch.tensor(probs), torch.tensor(g)).tolist()
    j = np.asarray(js.gumbel_argmax_with_noise(jnp.asarray(probs), jnp.asarray(g))).tolist()
    assert p == j == [1, 0]


def test_top_p_tie_order_matches_jax():
    """Equal logits straddling the nucleus cut: the port removes the same
    ids as JAX (its stable-sort order reversed)."""
    from gsv_tts_tpu.ops import sampling as js
    from gsv_tts_tpu_torch.ops import sampling as ps

    logits = np.log(np.asarray([[0.3, 0.2, 0.2, 0.2, 0.1]], np.float32))
    for top_p in (0.45, 0.55, 0.75, 0.95):
        j = np.isfinite(np.asarray(js.apply_top_p(jnp.asarray(logits), top_p)))
        p = torch.isfinite(ps.apply_top_p(torch.tensor(logits), top_p)).numpy()
        assert np.array_equal(p, j), top_p


def test_twin_sampler_ties_and_top_k_pivot():
    """K1's sampler: top-k keeps ties at the pivot, top-p keeps the top-1
    even past the cut, and with zero noise the lowest id among equal
    maxima wins."""
    from gsv_tts_tpu_torch.ops.fused_step import NEG, filter_row_ref
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    row = torch.tensor([[1.0, 3.0, 2.0, 3.0, 2.0, 0.5]])
    buf = torch.full((1, 8), 6, dtype=torch.int32)
    out = filter_row_ref(row, buf, 0, False, (), SampleArgs(top_k=3, use_prev=False))
    assert torch.equal(out, torch.tensor([[NEG, 3.0, 2.0, 3.0, 2.0, NEG]]))
    assert int(torch.argmax(out)) == 1
    out = filter_row_ref(row, buf, 0, False, (), SampleArgs(top_k=6, top_p=0.01, use_prev=False))
    assert (out[0] > NEG / 2).nonzero().flatten().tolist() == [1]  # first of the tied maxima


def test_twin_sampler_suppression_and_penalty():
    from gsv_tts_tpu_torch.ops.fused_step import NEG, filter_row_ref
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    row = torch.tensor([[2.0, -1.0, 0.5, 4.0]])
    buf = torch.tensor([[0, 1, 3, 9, 9]], dtype=torch.int32)  # 9: out of range, ignored
    out = filter_row_ref(row, buf, 2, True, (3, 280), SampleArgs(top_k=4, repetition_penalty=2.0))
    # id 3 suppressed; ids 0 and 1 penalised (divide / multiply); 3 not in buf[:2]
    assert torch.equal(out, torch.tensor([[1.0, -2.0, 0.5, NEG]]))
