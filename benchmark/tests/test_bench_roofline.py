"""The yardstick's operation and byte counts against hand counts."""
import json

from harness import roofline
from harness.cli import HERE


def s1v3():
    return roofline.Dims(json.loads((HERE / "configs" / "gsv-v2-en.json").read_text())["t2s"])


def test_k1_bound_at_the_s1v3_shapes():
    cfg = s1v3()
    L, D, M, V = 24, 512, 2048, 1025
    assert roofline.weight_bytes(cfg) == 2 * (L * (4 * D * D + 2 * D * M) + V * D)
    n_bytes, n_flops = roofline.step_counts(cfg, 1024, [777])
    # 152 MB of weights, 38 MB of cache at kv_len 777 (PERF.md: 190.7 MB)
    assert abs(n_bytes / 1e6 - 190.7) < 0.1
    seconds, what = roofline.step_bound(cfg, 1024, [777])
    assert what == "bytes"
    assert abs(seconds * 1e3 - 0.0569) < 0.0001
    per_slot = 2 * D + 4 * D + 4 * L * 777 * D + 4 * L * D + 8 * V + 4 * 1024 + 24
    assert n_flops == 2 * (L * (4 * D * D + 2 * D * M) + V * D) + 4 * L * 778 * D
    assert per_slot == n_bytes - roofline.weight_bytes(cfg) - L * (2 * (3 * D + D + M + D)
                                                                   + 4 * 4 * D)


def test_batched_step_reads_weights_once():
    cfg = s1v3()
    one, _ = roofline.step_counts(cfg, 1024, [300])
    four, _ = roofline.step_counts(cfg, 1024, [300] * 4)
    w = roofline.weight_bytes(cfg)
    assert four - w < 4 * (one - w) + 1e-9 and four < 2 * one


def test_attention_and_layer_bounds():
    t, what = roofline.attn_bound(16, 32, [300] * 12, 2)
    n = 12 * 301
    assert what == "bytes"
    assert abs(t - (4 * n * 512 + 12 * (2 * 2 * 512 + 4)) / roofline.HBM_BYTES_PER_S) < 1e-15
    cfg = s1v3()
    k5, _ = roofline.layers_bound(cfg, 24, [777], 2)
    assert abs(k5 * 1e3 - 0.0566) < 0.0002   # PERF.md: K5's bound 0.0566 ms


def test_decode_seconds_sums_each_step():
    class Ctx:
        dims = s1v3()
        gpt_cache = [(1, 512), (1, 1024)]

    reqs = [{"decode_steps": 3, "prompt_len": 100}, {"decode_steps": 0, "prompt_len": 5}]
    want = sum(roofline.step_bound(Ctx.dims, 512, [100 + i])[0] for i in range(3))
    assert abs(roofline.decode_seconds(Ctx, reqs) - want) < 1e-15
