"""The probes of ``gsv_tts_tpu_torch/tools`` (P1 int4 unpack, P2 reduce / mask
constructs, P3 weight stream) on the CPU: each twin against the TPU probe of
``tools/`` run in Pallas's interpret mode on the same numpy inputs, each
twin against numpy, and each command line.  The kernels themselves run on
the card only (``tests/test_torch_cuda.py``).

``tools/`` has no ``__init__.py``: the TPU probes are loaded by path.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gsv_tts_tpu_torch import tools
from gsv_tts_tpu_torch.tools import int4_probe, mosaic_probe, stream_probe

ROOT = Path(__file__).resolve().parents[1]


def load_tpu_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"tpu_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# P1: int4 unpack + product
# ---------------------------------------------------------------------------

def tpu_int4(tool, variant, x, packed, scale):
    """The TPU probe's ``pallas_call`` (``tools/int4_probe.py:74-91``) with
    ``interpret=True``."""
    D, N = tool.D, tool.N
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    hbm = pl.BlockSpec(memory_space=pltpu.MemorySpace.ANY)
    scratch = []
    if variant == "unpack_dma":
        scratch = [pltpu.VMEM((2, D, N // 2), jnp.int8), pltpu.SemaphoreType.DMA]
    out = pl.pallas_call(
        functools.partial(tool._kernel, variant),
        in_specs=[vmem, vmem if variant == "unpack" else hbm, vmem],
        out_specs=vmem,
        out_shape=jax.ShapeDtypeStruct((8, N), jnp.float32),
        scratch_shapes=scratch,
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale))
    return np.asarray(out)


@pytest.mark.parametrize("variant", ["unpack", "unpack_dma"])
def test_p1_twin_matches_tpu_probe(variant):
    """The twin on the exact ``packed`` array the TPU probe builds, within
    1e-5 of max |ref|: both sum exact bf16 products in float32, in other
    orders."""
    tool = load_tpu_tool("int4_probe")
    assert (tool.D, tool.N) == (int4_probe.D, int4_probe.N)
    x, q, packed, scale = int4_probe.make_inputs(0)
    ref = tpu_int4(tool, variant, x, packed, scale)
    got = int4_probe.int4_unpack_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                                        torch.from_numpy(scale), variant=variant).numpy()
    assert got.shape == ref.shape == (8, int4_probe.N)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_p1_unpack_and_twin_match_numpy():
    """The nibble unpack returns q exactly; the twin equals the float64
    product of the bf16-rounded x and q, times the scale."""
    x, q, packed, scale = int4_probe.make_inputs(3, d=64, n=128)
    w = int4_probe.unpack_int4(torch.from_numpy(packed))
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(), q.astype(np.float32))
    got = int4_probe.int4_unpack_matmul_plain(torch.from_numpy(x), torch.from_numpy(packed),
                                              torch.from_numpy(scale)).numpy()
    want = int4_probe.reference(x, q, scale)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


P1_SHAPES = {"probe": (int4_probe.D, int4_probe.N), "mlp1": (512, 2048),
             "stack": int4_probe.STACK}


@pytest.mark.parametrize("variant", ["unpack", "unpack_dma"])
@pytest.mark.parametrize("shape", ["probe", "mlp1", "stack"])
def test_p1_plan_covers_every_column_and_row_once_and_fits(shape, variant):
    """The redesign's plan on 132 SMs: the column tiles cover the N/2 byte
    columns once (so each output column, low and high nibble, once); the
    splits' row runs partition D in whole stages; a block's shared memory
    fits (two blocks an SM for ``unpack``) with x's slice at its bank-free
    stride; the stack shape gets at least 132 blocks, the small shapes one
    split (one launch)."""
    d, n = P1_SHAPES[shape]
    half = n // 2
    p = int4_probe.plan(d, half, variant)
    assert p.tiles * p.tile == half and p.tile % 128 == 0
    assert p.col_warps * p.k_warps == int4_probe.WARPS
    assert (p.stages - 1) * p.stage_rows < d <= p.stages * p.stage_rows
    runs = [p.split_rows(s) for s in range(p.splits)]
    assert runs[0][0] == 0 and runs[-1][1] == d
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert all(lo < hi and lo % p.stage_rows == 0 for lo, hi in runs)
    if p.splits > 1:
        assert all(hi - lo >= int4_probe.MIN_STAGES * p.stage_rows for lo, hi in runs[:-1])
    assert p.xs >= max(hi - lo for lo, hi in runs) and (2 * p.xs) % 128 == 32
    assert p.smem <= tools.MAX_SMEM
    if variant == "unpack":
        assert p.ring == 0 and 2 * (p.smem + 1024) <= 233472  # 228 KB an SM
    else:
        assert 1 <= p.ring <= int4_probe.RING
    if shape == "stack":
        assert p.blocks >= 132 and p.blocks % 132 == 0
    else:
        assert p.splits == 1 or variant == "unpack_dma"


def test_p1_nibble_conversion_equals_unpack_int4_for_every_byte():
    """The kernel's unpack, modelled in numpy: xor 0x88 gives both nibbles
    as u = v + 8; 0x4300 | u is the bf16 128 + u; minus 136 is v.  For all
    256 bytes, bit for bit the twin's ``unpack_int4`` (low nibble, then
    high); and the word-level form (one lop3 of the nibble pair at bits
    0-3 and 16-19 with 0x000F000F and 0x43084308) gives the same bits."""
    byte = np.arange(256, dtype=np.uint32)
    u = byte ^ 0x88
    lo_bits, hi_bits = 0x4300 | (u & 15), 0x4300 | (u >> 4)
    as_float = lambda bits: ((bits << 16).astype(np.uint32)).view(np.float32) - 136  # noqa: E731
    want = int4_probe.unpack_int4(torch.from_numpy(byte.astype(np.uint8).view(np.int8))
                                  .reshape(256, 1)).float().numpy()
    np.testing.assert_array_equal(as_float(lo_bits), want[:, 0])
    np.testing.assert_array_equal(as_float(hi_bits), want[:, 1])
    word = byte | (np.roll(byte, 7) << 16)  # two bytes a word: bits 0-7 and 16-23
    for shift, bits in ((0, lo_bits), (4, hi_bits)):
        pair = _lop3_nibbles(word >> shift)
        np.testing.assert_array_equal(pair & 0xFFFF, bits)
        np.testing.assert_array_equal(pair >> 16, np.roll(bits, 7))


def _lop3_nibbles(w):
    """``lop3.b32 r, w, 0x000F000F, 0x43084308, 0x6A``: b ? a ^ c : c."""
    mask, c = np.uint32(0x000F000F), np.uint32(0x43084308)
    return ((mask & (w ^ c)) | (~mask & c)).astype(np.uint32)


def _byte_perm(a, b, sel):
    """``__byte_perm(a, b, sel)``: byte i of the result is byte
    (sel >> 4i) & 7 of the pair (a: bytes 0-3, b: 4-7)."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _bf16_pair(r):
    """A register of two bf16 (after the fma with 1 and -136) as two floats."""
    lo = ((r & 0xFFFF) << 16).astype(np.uint32).view(np.float32) - 136
    hi = ((r >> 16) << 16).astype(np.uint32).view(np.float32) - 136
    return lo, hi


def emulate_p1(x, packed, scale, p):
    """A numpy model of ``csrc/p1_int4_probe.cu``'s redesign, following its
    data path: x staged as bf16 with each 16-row run permuted; per warp and
    step, lane (g, t)'s 16 bytes of rows t + 4i, the byte permutes, shifts
    and lop3 into the A fragments of mma.sync m16n8k16 (a0: row g, k 2t /
    2t + 1; a1: row g + 8; a2, a3: k + 8), its B fragment from the staged x,
    the product, the C fragments into the warps' sums at 8b + g, the
    epilogue's decode back to columns, the splits' partials summed in split
    order, then the scale."""
    d, half = packed.shape
    n = 2 * half
    u8 = packed.view(np.uint8)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    parts = np.zeros((p.splits, 8, n))
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    for split in range(p.splits):
        row0, row1 = p.split_rows(split)
        k = np.arange(row1 - row0)
        xs = np.zeros((8, p.xs), np.float32)
        xs[:, (k & ~15) + 4 * (k & 3) + ((k & 15) >> 2)] = xb[:, row0 + k]
        n_st = -(-(row1 - row0) // p.stage_rows)
        for tile in range(p.tiles):
            c0 = tile * p.tile
            sums = np.zeros((int4_probe.WARPS, 8, 2 * 128 + 4))
            for warp in range(int4_probe.WARPS):
                cw, kw = warp % p.col_warps, warp // p.col_warps
                acc = np.zeros((16, 32, 4))
                for s in range(n_st):
                    r = row0 + s * p.stage_rows + 16 * kw
                    if r >= row1:
                        continue
                    cols = c0 + 128 * cw + 16 * g[:, None] + np.arange(16)     # [lane, 16]
                    rows = r + t[:, None] + 4 * np.arange(4)                   # [lane, 4]
                    v = u8[rows[:, :, None], cols[:, None, :]]                 # [lane, 4, 16]
                    words = np.ascontiguousarray(v).view("<u4").astype(np.uint32)  # [lane, 4, 4]
                    xp = xs[g[:, None], (r - row0) + 4 * t[:, None] + np.arange(4)]  # [lane, 4]
                    B = np.zeros((16, 8))
                    for i, kk in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
                        B[kk, g] = xp[:, i]
                    A = np.zeros((16, 16, 16))
                    for w in range(4):
                        r0, r1, r2, r3 = (words[:, i, w] for i in range(4))
                        for h in range(2):
                            sel = 0x7632 if h else 0x5410
                            p01, p23 = _byte_perm(r0, r1, sel), _byte_perm(r2, r3, sel)
                            for e in range(2):
                                b = 4 * w + 2 * h + e
                                frags = [_bf16_pair(_lop3_nibbles(q >> sh)) for q, sh in
                                         ((p01, 8 * e), (p01, 8 * e + 4),
                                          (p23, 8 * e), (p23, 8 * e + 4))]
                                for (lo, hi), m, k0 in zip(frags, (g, g + 8, g, g + 8),
                                                           (2 * t, 2 * t, 2 * t + 8, 2 * t + 8)):
                                    A[b, m, k0], A[b, m, k0 + 1] = lo, hi
                    C = A @ B                                                  # [b, m, n]
                    acc[:, :, 0] += C[:, g, 2 * t]
                    acc[:, :, 1] += C[:, g, 2 * t + 1]
                    acc[:, :, 2] += C[:, g + 8, 2 * t]
                    acc[:, :, 3] += C[:, g + 8, 2 * t + 1]
                for b in range(16):
                    for e in range(2):
                        sums[warp, 2 * t + e, 8 * b + g] = acc[b, :, e]
                        sums[warp, 2 * t + e, 128 + 8 * b + g] = acc[b, :, 2 + e]
            for i in range(8 * p.col_warps * 256):
                q, hl, rest = i & 127, (i >> 7) & 1, i >> 8
                cwi, r = rest % p.col_warps, rest // p.col_warps
                pos = hl * 128 + 8 * (q & 15) + (q >> 4)
                val = sum(sums[kk * p.col_warps + cwi, r, pos] for kk in range(p.k_warps))
                parts[split, r, c0 + 128 * cwi + q + hl * half] = val
    return parts.sum(axis=0) * scale


@pytest.mark.parametrize("d,n,variant,sms", [(80, 256, "unpack", 132),
                                             (1024, 256, "unpack", 4),
                                             (528, 512, "unpack_dma", 4),
                                             (256, 1024, "unpack_dma", 132),
                                             (256, 2048, "unpack_dma", 132)])
def test_p1_kernel_model_matches_the_reference(d, n, variant, sms):
    """The numpy model of the kernel's data path equals the float64
    reference (exact products; float64 sums): one short stage (D = 80),
    two splits of one column warp, a dma plan of two column warps whose last
    stage is short, one of four column warps in two splits, one of eight
    column warps (a 16-row stage) in four."""
    x, q, packed, scale = int4_probe.make_inputs(7, d=d, n=n)
    p = int4_probe.plan(d, n // 2, variant, sms)
    assert p.splits > 1 or d == 80
    got = emulate_p1(x, packed, scale, p)
    np.testing.assert_allclose(got, int4_probe.reference(x, q, scale), rtol=1e-12, atol=1e-12)


def test_p1_twin_at_a_stacked_shape_matches_numpy():
    """Four 64-row layer pages stacked as one int4 page (D = 4 x 64, the
    stack shape in small): the twin equals the float64 reference, and the
    sum of the four pages' own products, within 1e-6 of max |ref|."""
    x, q, packed, scale = int4_probe.make_inputs(11, d=4 * 64, n=256)
    got = int4_probe.int4_unpack_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                                        torch.from_numpy(scale)).numpy()
    want = int4_probe.reference(x, q, scale)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    layers = sum(int4_probe.reference(np.ascontiguousarray(x[:, 64 * i:64 * (i + 1)]),
                                      q[64 * i:64 * (i + 1)], scale) for i in range(4))
    assert np.abs(got - layers).max() <= 1e-6 * np.abs(want).max()


def test_p1_and_p2_wrappers_refuse_what_the_kernels_do_not_take():
    """Shapes outside the plan (D not a multiple of 16, N/2 not of 128) and
    other dtypes raise ValueError on any device; no twin runs in their
    place."""
    x, _, packed, scale = (torch.from_numpy(a) for a in int4_probe.make_inputs(0, d=64, n=256))
    with pytest.raises(ValueError, match="multiple of 16"):
        int4_probe.int4_unpack_matmul(x[:, :56].contiguous(), packed[:56], scale)
    x2, _, packed2, scale2 = (torch.from_numpy(a)
                              for a in int4_probe.make_inputs(0, d=64, n=128))
    for v in int4_probe.VARIANTS:
        with pytest.raises(ValueError, match="multiple of 128"):
            int4_probe.int4_unpack_matmul(x2, packed2, scale2, variant=v)
    with pytest.raises(ValueError, match="dtypes"):
        int4_probe.int4_unpack_matmul(x.double(), packed, scale)
    with pytest.raises(ValueError, match="dtypes"):
        int4_probe.int4_unpack_matmul(x, packed.to(torch.uint8), scale)
    with pytest.raises(ValueError, match="variant"):
        int4_probe.plan(64, 128, "unpack4")
    with pytest.raises(ValueError, match="want"):
        mosaic_probe.mosaic_reduce(torch.zeros((256, 16), dtype=torch.float64), "combined")


def test_p1_main_on_cpu_prints_pass(capsys):
    assert int4_probe.main(["unpack_dma", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "unpack_dma: rel_err=" in out and out.rstrip().endswith("PASS")


def test_p1_main_runs_each_variant_in_its_own_process(capsys):
    """With no variant named, each runs as ``python -m ... <variant>`` under
    a timeout, as the TPU probe's command does."""
    assert int4_probe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for v in int4_probe.VARIANTS:
        assert any(ln.startswith(f"{v}: rel_err=") and ln.endswith(" PASS")
                   for ln in out.splitlines())


# ---------------------------------------------------------------------------
# P2: reduce / mask constructs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["baseline", "reduce3d", "bcastcmp", "combined"])
def test_p2_twin_matches_tpu_probe(variant):
    """rtol 1e-5, atol 1e-5 (float32 sums of 16..256 terms in other orders),
    except ``bcastcmp``: its values are about -5.4e10, 54 rows of -1e9 and ten
    of x, where one float32 step is 4096 and the summation order moves the
    result by a few of them.  So the x terms are below its resolution, and
    all the comparison can show is that the mask kept ten rows of block 0
    and summed 54 fills: held relative to |ref| at 1e-6."""
    tool = load_tpu_tool("mosaic_probe")
    assert (tool.B, tool.BLOCK, tool.H) == (mosaic_probe.B, mosaic_probe.BLOCK, mosaic_probe.H)
    x = mosaic_probe.make_input(0)
    ref = np.asarray(pl.pallas_call(
        functools.partial(tool._kernel, variant),
        out_shape=jax.ShapeDtypeStruct((1, tool.H), jnp.float32),
        interpret=True,
    )(jnp.asarray(x)))
    got = mosaic_probe.mosaic_reduce(torch.from_numpy(x), variant).numpy()
    assert got.shape == ref.shape == (1, 16)
    if variant == "bcastcmp":
        assert np.all(np.abs(got - ref) <= 1e-6 * np.abs(ref))
        assert np.all(np.abs(ref + 5.4e10) < 1e7)  # 54 fills of -1e9, ten x rows
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_p2_twins_match_numpy():
    """Each variant against a numpy loop written from the TPU kernel's
    text, in float64."""
    x = mosaic_probe.make_input(5).astype(np.float64)
    x3 = x.reshape(4, 64, 16)
    lens = np.array([10, 20, 30, 40]).reshape(4, 1, 1)
    mask = np.arange(64).reshape(1, 64, 1) < lens
    acc = np.zeros((1, 16))
    for _ in range(3):
        y = (x + acc[0, 0]).reshape(4, 64, 16)
        acc = acc + np.where(mask, np.exp(y - y.max(axis=1, keepdims=True)), 0).sum(axis=1)[0:1]
    want = {"baseline": x.max(axis=0, keepdims=True) + x.sum(axis=0, keepdims=True),
            "reduce3d": (x3.max(axis=1) + x3.sum(axis=1))[0:1],
            "bcastcmp": np.where(mask, x3, -1e9).sum(axis=1)[0:1],
            "combined": acc}
    for variant, w in want.items():
        got = mosaic_probe.mosaic_reduce_plain(torch.from_numpy(x), variant).numpy()
        np.testing.assert_allclose(got, w, rtol=1e-12, atol=1e-9, err_msg=variant)


def test_p2_main_on_cpu_prints_ok(capsys):
    mosaic_probe.main(["combined", "--device", "cpu"])
    assert "combined: OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# P3: weight stream
# ---------------------------------------------------------------------------

SMALL = dict(L=2, D=128, W=512)
P3_VARIANTS = ["xla", "fori", "grid", "fori64", "fori256"]


@pytest.fixture
def tpu_stream(monkeypatch):
    """The TPU stream probe at a small size, its Pallas calls interpreted."""
    tool = load_tpu_tool("stream_probe")
    for name, v in SMALL.items():
        monkeypatch.setattr(tool, name, v)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    return tool


def small_inputs(rows, seed=0):
    """w [L, D, W] and x [1, rows] as float32 arrays of bf16 values (the
    same bits on both sides)."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(SMALL["L"], SMALL["D"], SMALL["W"]).astype(np.float32) * 0.02)
    x = torch.from_numpy(rng.randn(1, rows).astype(np.float32) * 0.1)
    return w.to(torch.bfloat16).float().numpy(), x.to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("variant", P3_VARIANTS)
def test_p3_twin_matches_tpu_probe_one_step_and_a_chain(tpu_stream, variant):
    """One step within rtol 1e-5 (float32 sums in other orders): the row the
    TPU tool's variant returns, and, at rows = D, the other row against the
    TPU tool's other function (``xla``'s step for the kernels, a ``fori``
    step for ``xla``); then a 3-step tanh chain: every port step from the
    TPU chain's state within 1e-5, and the final bf16 states within one bf16
    rounding of each other."""
    rows, step = tpu_stream._make_step(variant)
    assert rows == stream_probe.rows_of(variant, SMALL["D"])
    w, x = small_inputs(rows)
    wj, xj = jnp.asarray(w, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    wt, xt = torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    ref = np.asarray(step(xj, wj))
    out = stream_probe.stream_step(xt, wt, variant)
    assert out.shape == (2, rows) and ref.shape == (1, rows)
    np.testing.assert_allclose(stream_probe.result(out, variant).numpy(), ref, rtol=1e-5,
                               atol=1e-7)
    if rows == SMALL["D"]:
        other = "fori" if variant == "xla" else "xla"
        _, other_step = tpu_stream._make_step(other)
        np.testing.assert_allclose(stream_probe.result(out, other).numpy(),
                                   np.asarray(other_step(xj, wj)), rtol=1e-5, atol=1e-7)

    for _ in range(3):
        ref = np.asarray(step(xj, wj))
        got = stream_probe.stream_step(
            torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16), wt, variant)
        np.testing.assert_allclose(stream_probe.result(got, variant).numpy(), ref, rtol=1e-5,
                                   atol=1e-7)
        xj = jnp.tanh(step(xj, wj)).astype(jnp.bfloat16)
    final = stream_probe.chain(xt, wt, variant, 3).float().numpy()
    np.testing.assert_allclose(final, np.asarray(xj.astype(jnp.float32)), rtol=2 ** -8, atol=0)


def test_p3_twin_matches_numpy():
    """Every variant: y = sum over pages of x @ w_p over all W columns; row 0
    of a step is y[:rows], row 1 is y folded by ``rows``."""
    w, _ = small_inputs(8)
    for variant in ("fori64", "fori", "k1ring", "grid", "xla"):
        rows = stream_probe.rows_of(variant, SMALL["D"])
        _, x = small_inputs(rows, seed=1)
        got = stream_probe.stream_step(torch.from_numpy(x).to(torch.bfloat16),
                                       torch.from_numpy(w).to(torch.bfloat16), variant)
        pages = w.astype(np.float64).reshape(-1, rows, SMALL["W"])
        y = np.einsum("k,pkc->c", x[0].astype(np.float64), pages)
        want = np.stack([y[:rows], y.reshape(-1, rows).sum(axis=0)])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7, err_msg=variant)


def test_p3_ring_plan_moves_whole_shares():
    """On 132 SMs at the probe's width: fori256 / fori / fori1024 move a
    block's share of a page in one copy through two slots; fori2048's share
    (16 rows, 196,608 bytes) does not fit two slots, so it moves in copies of
    9 rows, two a page; k1ring's 4-row share goes through K1's 8 slots one
    12,288-byte row a copy (what fits K1's 16 KB stage); no plan shortens a
    page."""
    width = stream_probe.W
    want = {"fori256": (2, 2, 2, 1), "fori": (4, 2, 4, 1), "fori1024": (8, 2, 8, 1),
            "fori2048": (16, 2, 9, 2), "k1ring": (4, 8, 1, 4)}
    for variant, (share, stages, chunk, per_page) in want.items():
        plan = stream_probe.ring_plan(variant, stream_probe.rows_of(variant, 512), width, 132)
        assert (plan.share, plan.stages, plan.chunk_rows, plan.copies_per_page) == (
            share, stages, chunk, per_page)
        assert plan.chunk_rows * plan.copies_per_page >= plan.share
        assert plan.copy_bytes == 2 * width * chunk and plan.copy_bytes % 16 == 0
        assert plan.smem <= tools.MAX_SMEM
    assert stream_probe.ring_plan("k1ring", 128, 512, 132).chunk_rows == 16  # 16 KB of 1 KB rows


def test_p3_main_on_cpu_prints_its_line(monkeypatch, capsys):
    for name, v in dict(SMALL, REPS=3).items():
        monkeypatch.setattr(stream_probe, name, v)
    stream_probe.main(["fori64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fori64:" in out and "ms/step" in out and "us/page x 4" in out
    assert "not a device time" in out


def test_p3_make_inputs_prefix_property(monkeypatch):
    """x0 for fewer rows is a prefix of x0 for more (the smoke builds w once)."""
    for name, v in SMALL.items():
        monkeypatch.setattr(stream_probe, name, v)
    w1, x1 = stream_probe.make_inputs(64)
    w2, x2 = stream_probe.make_inputs(256)
    assert torch.equal(w1, w2) and torch.equal(x1, x2[:, :64])


# ---------------------------------------------------------------------------
# No fallback: the card or a refusal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool", [int4_probe, mosaic_probe, stream_probe])
def test_probes_refuse_a_missing_card(tool, monkeypatch):
    """The default device is the card; without one the tool raises and never
    runs the twin in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    variant = {int4_probe: "unpack", mosaic_probe: "baseline", stream_probe: "fori"}[tool]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.run_variant(variant)


def test_probe_wrappers_refuse_other_devices_and_shapes():
    """Tensors on neither CPU nor CUDA, and shapes the kernels do not take,
    raise ValueError."""
    x, q, packed, scale = int4_probe.make_inputs(0)
    meta = [torch.empty(a.shape, dtype=t, device="meta")
            for a, t in ((x, torch.float32), (packed, torch.int8), (scale, torch.float32))]
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        int4_probe.int4_unpack_matmul(*meta, variant="unpack")
    with pytest.raises(ValueError, match="variant"):
        int4_probe.int4_unpack_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                                      torch.from_numpy(scale), variant="unpack4")
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        mosaic_probe.mosaic_reduce(torch.empty((256, 16), device="meta"), "baseline")
    with pytest.raises(ValueError, match="want"):
        mosaic_probe.mosaic_reduce(torch.zeros((128, 16)), "baseline")
    w = torch.empty((2, 128, 512), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="kernels run on CUDA"):
        stream_probe.stream_step(torch.empty((1, 128), dtype=torch.bfloat16, device="meta"), w,
                                 "fori")
    with pytest.raises(ValueError, match="whole rows"):
        stream_probe.stream_step(torch.zeros((1, 96), dtype=torch.bfloat16),
                                 torch.zeros((2, 128, 512), dtype=torch.bfloat16), "fori96")
    with pytest.raises(ValueError, match="unknown variant"):
        stream_probe.rows_of("fori_x", 128)
