"""The host side of the attention kernels K3 (``ops/flash_decode.py``) and K4
(``ops/flash_prefill.py``), and of the layer kernel K6 (``ops/fused_layer.py``),
that runs without a card: the cluster plan of the one-launch decode
attention, and the memoized argument checks of the three wrappers, called
with the metadata a CUDA tensor would have (shape, strides, dtype, device,
``data_ptr() % 16``).  The kernels themselves are held against their twins
in ``test_torch_cuda.py``."""
import pytest
import torch

from gsv_tts_tpu_torch.ops import flash_decode as fd
from gsv_tts_tpu_torch.ops import flash_prefill as fp
from gsv_tts_tpu_torch.ops.flash_decode import ATTN_ROWS

CUDA = torch.device("cuda", 0)
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 8, 9, 12, 20, 64])
def test_cluster_plan_is_a_power_of_two_that_fits(B, sms):
    """For every (H, S) on a card of ``sms`` SMs: C is 1, 2 or 4; a cluster
    never has more blocks than its rows give ``ATTN_ROWS`` to; more than one
    block per (slot, head) only while the grid fits the SMs; and C is the
    largest such up to ``PLAN_MAX_CLUSTER``."""
    assert fd.PLAN_MAX_CLUSTER <= fd.MAX_CLUSTER
    for H in (1, 2, 4, 16, 32):
        for S in (1, 63, 64, 127, 128, 200, 256, 512, 1024, 4096):
            C = fd.cluster_plan(B, H, S, sms)
            assert C in (1, 2, 4)
            assert C == 1 or (C * ATTN_ROWS <= S and B * H * C <= sms)
            bigger = 2 * C
            assert (C == fd.PLAN_MAX_CLUSTER or bigger * ATTN_ROWS > S
                    or B * H * bigger > sms), (B, H, S, sms, C)


@pytest.mark.parametrize("B,H,S,sms,C", [
    (1, 16, 1024, 132, 4), (1, 16, 512, 132, 4), (2, 16, 1024, 132, 4), (4, 16, 512, 132, 2),
    (8, 16, 1024, 132, 1), (9, 16, 512, 132, 1), (12, 16, 512, 132, 1), (1, 16, 200, 132, 2),
    (1, 16, 64, 132, 1), (1, 16, 1024, 66, 4), (2, 16, 1024, 66, 2), (1, 16, 1024, 40, 2)])
def test_cluster_plan_at_the_engine_shapes(B, H, S, sms, C):
    assert fd.cluster_plan(B, H, S, sms) == C


def _contig(shape):
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def _t(shape, dtype, dev=CUDA, stride=None, mis=0):
    return tuple(shape), stride or _contig(shape), dtype, dev, mis


def _k3(B=3, S=256, L=4, H=4, Dh=32, **over):
    """Metadata of a layered K3b call; ``over`` replaces one tensor's."""
    args = dict(q=_t((B, H, Dh), BF16), k=_t((L, B, S, H, Dh), BF16),
                v=_t((L, B, S, H, Dh), BF16), kv=_t((B,), torch.int32))
    args.update(over)
    return args["q"], args["k"], args["v"], args["kv"]


K3_BAD = {
    "cache dtype": (dict(k=_t((4, 3, 256, 4, 32), F32)), "k_cache must be"),
    "cache alignment": (dict(v=_t((4, 3, 256, 4, 32), BF16, mis=8)), "v_cache must be"),
    "q not contiguous": (dict(q=_t((3, 4, 32), BF16, stride=(256, 64, 1))), "q must be"),
    "q dtype": (dict(q=_t((3, 4, 32), torch.float16)), "q dtype"),
    "kv_len dtype": (dict(kv=_t((3,), torch.int64)), "kv_len must be"),
    "kv_len device": (dict(kv=_t((3,), torch.int32, dev=torch.device("cuda", 1))),
                      "kv_len must be"),
    "kv_len shape": (dict(kv=_t((2,), torch.int32)), "kv_len"),
    "q shape": (dict(q=_t((3, 2, 32), BF16)), "q "),
    "head dim": (dict(q=_t((3, 4, 24), BF16), k=_t((4, 3, 256, 4, 24), BF16),
                      v=_t((4, 3, 256, 4, 24), BF16)), "head dim 24"),
    "cache shapes": (dict(v=_t((4, 3, 255, 4, 32), BF16)), "cache shapes"),
    "not on CUDA": (dict(q=_t((3, 4, 32), BF16, dev=torch.device("cpu")),
                         k=_t((4, 3, 256, 4, 32), BF16, dev=torch.device("cpu")),
                         v=_t((4, 3, 256, 4, 32), BF16, dev=torch.device("cpu")),
                         kv=_t((3,), torch.int32, dev=torch.device("cpu"))), "runs on CUDA"),
}


@pytest.mark.parametrize("case", sorted(K3_BAD))
def test_k3_memoized_checks_still_raise(case):
    """A good call memoizes its plan; each bad input, under another key,
    still raises, and the good key is then served from the memo."""
    good = _k3(B=3)
    plan = fd.launch_plan(True, *good, 132)
    assert plan == fd.Plan(L=4, B=3, S=256, H=4, Dh=32, q_f32=0,
                           C=fd.cluster_plan(3, 4, 256, 132))
    over, match = K3_BAD[case]
    with pytest.raises(ValueError, match=match):
        fd.launch_plan(True, *_k3(B=3, **over), 132)
    hits = fd.launch_plan.cache_info().hits
    assert fd.launch_plan(True, *good, 132) is plan
    assert fd.launch_plan.cache_info().hits == hits + 1
    with pytest.raises(ValueError, match=match):  # a failure is never memoized
        fd.launch_plan(True, *_k3(B=3, **over), 132)


def test_k3_plan_of_one_layers_cache_and_float32_queries():
    plan = fd.launch_plan(False, _t((1, 16, 32), F32), _t((1, 1024, 16, 32), BF16),
                          _t((1, 1024, 16, 32), BF16), _t((1,), torch.int32), 132)
    assert plan == fd.Plan(L=1, B=1, S=1024, H=16, Dh=32, q_f32=1, C=4)
    # the card's SM count is part of the key: a smaller card gets its own plan
    small = fd.launch_plan(False, _t((4, 16, 32), F32), _t((4, 1024, 16, 32), BF16),
                           _t((4, 1024, 16, 32), BF16), _t((4,), torch.int32), 66)
    assert small.C == 1


def _k4(B=2, T=96, H=4, Dh=32, dtype=BF16, **over):
    """Metadata of a K4 call on strided views of one [B, T, 3D] product."""
    D = H * Dh
    view = _t((B, T, H, Dh), dtype, stride=(T * 3 * D, 3 * D, Dh, 1))
    args = dict(q=view, k=view, v=view, xl=_t((B,), torch.int32), xyl=_t((B,), torch.int32))
    args.update(over)
    return args["q"], args["k"], args["v"], args["xl"], args["xyl"]


K4_BAD = {
    "row stride": (dict(k=_t((2, 96, 4, 32), BF16, stride=(96 * 390, 390, 32, 1))),
                   "16-byte aligned rows"),
    "alignment": (dict(v=_t((2, 96, 4, 32), BF16, stride=(96 * 384, 384, 32, 1), mis=2)),
                  "16-byte aligned rows"),
    "last stride": (dict(q=_t((2, 96, 4, 32), BF16, stride=(96 * 384, 384, 1, 4))),
                    "contiguous last dimension"),
    "dtype mismatch": (dict(v=_t((2, 96, 4, 32), F32, stride=(96 * 384, 384, 32, 1))),
                       "v must be"),
    "float16": (dict(q=_t((2, 96, 4, 32), torch.float16), k=_t((2, 96, 4, 32), torch.float16),
                     v=_t((2, 96, 4, 32), torch.float16)), "dtype"),
    "lens dtype": (dict(xl=_t((2,), torch.int64)), "x_lens must be a contiguous int32"),
    "lens device": (dict(xyl=_t((2,), torch.int32, dev=torch.device("cuda", 1))),
                    "xy_lens must be a contiguous int32"),
    "lens stride": (dict(xl=_t((2,), torch.int32, stride=(2,))), "x_lens must be"),
    "lens shape": (dict(xyl=_t((3,), torch.int32)), r"xy_lens must be a \[2\] tensor"),
    "shapes": (dict(k=_t((2, 95, 4, 32), BF16)), "shapes"),
    "head dim": (dict(q=_t((2, 96, 4, 24), BF16), k=_t((2, 96, 4, 24), BF16),
                      v=_t((2, 96, 4, 24), BF16)), "head dim 24"),
}


@pytest.mark.parametrize("case", sorted(K4_BAD))
def test_k4_memoized_checks_still_raise(case):
    """As for K3: the plan of a good call is memoized, each bad input under
    another key still raises, every time."""
    good = _k4()
    plan = fp.launch_plan(*good, 4)
    assert plan.out_shape == (2, 96, 128)
    s = plan.shape
    assert (s.B, s.T, s.H, s.Dh, s.is_f32) == (2, 96, 4, 32, 0)
    assert (s.q_sb, s.q_st, s.q_sh, s.v_st) == (96 * 384, 384, 32, 384)
    over, match = K4_BAD[case]
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            fp.launch_plan(*_k4(**over), 4)
    assert fp.launch_plan(*good, 4) is plan


def test_k4_plan_checks_heads_and_float32_widths():
    with pytest.raises(ValueError, match="num_heads=2"):
        fp.launch_plan(*_k4(), 2)
    f32 = _k4(dtype=F32, Dh=128)
    with pytest.raises(ValueError, match="float32 with head dim 128"):
        fp.launch_plan(*f32, 4)
    assert fp.launch_plan(*_k4(dtype=F32, Dh=64), 4).shape.is_f32 == 1
    assert fp.launch_plan(*_k4(Dh=128), 4).shape.Dh == 128  # bf16 takes 128-wide heads


def _k6(B=3, S=256, L=4, H=4, Dh=32, x_dtype=BF16, **over):
    """Metadata of a K6 call; ``over`` replaces one tensor's."""
    args = dict(x=_t((B, H * Dh), x_dtype), k=_t((L, B, S, H, Dh), BF16),
                v=_t((L, B, S, H, Dh), BF16), kv=_t((B,), torch.int32))
    args.update(over)
    return args["x"], args["k"], args["v"], args["kv"]


K6_BAD = {
    "cache dtype": (dict(k=_t((4, 3, 256, 4, 32), F32)), "k_cache must be"),
    "cache alignment": (dict(v=_t((4, 3, 256, 4, 32), BF16, mis=8)), "v_cache must be"),
    "x not contiguous": (dict(x=_t((3, 128), BF16, stride=(256, 1))), "x must be"),
    "x dtype": (dict(x=_t((3, 128), torch.float16)), "x dtype"),
    "x shape": (dict(x=_t((3, 64), BF16)), r"x \(3, 64\) is not"),
    "kv_len dtype": (dict(kv=_t((3,), torch.int64)), "kv_len must be"),
    "kv_len device": (dict(kv=_t((3,), torch.int32, dev=torch.device("cuda", 1))),
                      "kv_len must be"),
    "kv_len shape": (dict(kv=_t((2,), torch.int32)), r"kv_len must be a \[3\] tensor"),
    "head dim": (dict(x=_t((3, 96), BF16), k=_t((4, 3, 256, 4, 24), BF16),
                      v=_t((4, 3, 256, 4, 24), BF16)), "head dim 24"),
    "cache shapes": (dict(v=_t((4, 3, 255, 4, 32), BF16)), "cache shapes"),
    "not on CUDA": (dict(x=_t((3, 128), BF16, dev=torch.device("cpu")),
                         k=_t((4, 3, 256, 4, 32), BF16, dev=torch.device("cpu")),
                         v=_t((4, 3, 256, 4, 32), BF16, dev=torch.device("cpu")),
                         kv=_t((3,), torch.int32, dev=torch.device("cpu"))), "runs on CUDA"),
}


@pytest.mark.parametrize("case", sorted(K6_BAD))
def test_k6_memoized_checks_still_raise(case):
    """K6's wrapper checks a call once per metadata key (it runs once per
    layer and step on the "fused" path): a good call memoizes its plan; each
    bad input, under another key, still raises, and is never memoized."""
    from gsv_tts_tpu_torch.ops import fused_layer as fl

    good = _k6(B=3)
    plan = fl.launch_plan(*good)
    assert plan == fl.Plan(L=4, B=3, S=256, H=4, Dh=32, x_f32=0)
    over, match = K6_BAD[case]
    with pytest.raises(ValueError, match=match):
        fl.launch_plan(*_k6(B=3, **over))
    hits = fl.launch_plan.cache_info().hits
    assert fl.launch_plan(*good) is plan
    assert fl.launch_plan.cache_info().hits == hits + 1
    with pytest.raises(ValueError, match=match):
        fl.launch_plan(*_k6(B=3, **over))


def test_k6_plan_of_float32_rows_and_a_wave_of_eleven():
    from gsv_tts_tpu_torch.ops import fused_layer as fl

    assert fl.launch_plan(*_k6(B=11, S=1024, L=24, H=16, Dh=32, x_dtype=F32)) == fl.Plan(
        L=24, B=11, S=1024, H=16, Dh=32, x_f32=1)
