"""The EOS length control at the published widths, on the CPU: EOS's logit
sits ``delta`` below the best code's, with spread ``gain``, and sampled
requests end at the model's own EOS before the cache's edge."""
import json

import numpy as np
import torch

from harness import cli, weights
from reference.t2s import T2SReference


def test_eos_logit_sits_delta_below_the_best_code():
    cfg = json.loads((cli.HERE / "configs" / "gsv-v2-en.json").read_text())
    table = weights.leaf_table("t2s-s1v3")
    ctl = cfg["assumed"]["eos_control"]
    for seed in (5, 6):
        gen = torch.Generator().manual_seed(seed)
        sd = weights.draw_part(table, gen, "cpu", torch.float32)
        weights.t2s_shaping(sd, table["meta"], cfg["assumed"]["t2s_shaping"])
        state = gen.get_state()
        mu, sigma, best = weights.eos_control(sd, table["meta"], ctl, gen)
        # the same probe again, now read through the controlled head
        gen.set_state(state)
        g2 = torch.Generator().manual_seed(0)
        g2.set_state(state)
        torch.randn(512, generator=g2)  # u
        x = torch.randint(1, 732, (100,), generator=g2)
        y = torch.randint(0, 1024, (300,), generator=g2)
        ref = T2SReference(sd, table["meta"], "cpu")
        lg = ref.logits(x.numpy(), y.numpy(), np.zeros((100, 1024), np.float32), 300)
        y2 = np.concatenate([y[:1].numpy(), lg[:, :1024].argmax(dim=1)[:-1].numpy()])
        lg = ref.logits(x.numpy(), y2, np.zeros((100, 1024), np.float32), 300)
        eos, top = lg[:, 1024], lg[:, :1024].max(dim=1).values
        assert abs(float(eos.mean() - top.mean()) - ctl["delta"]) < 0.2
        assert abs(float(eos.std()) - ctl["gain"]) < 0.2


def test_sampled_requests_end_at_eos_on_the_cpu():
    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.runtime.t2s_session import T2SEngine

    cfg = json.loads((cli.HERE / "configs" / "gsv-v2-en.json").read_text())
    table = weights.leaf_table("t2s-s1v3")
    gen = torch.Generator().manual_seed(cfg["assumed"]["weights_seed"])
    sd = weights.draw_part(table, gen, "cpu", torch.float32)
    weights.t2s_shaping(sd, table["meta"], cfg["assumed"]["t2s_shaping"])
    weights.eos_control(sd, table["meta"], cfg["assumed"]["eos_control"], gen)
    tcfg = t2s.T2SConfig.from_checkpoint_config(table["meta"])
    torch.set_num_threads(4)
    eng = T2SEngine(t2s.params_from_torch_state_dict(sd, tcfg), tcfg, gpt_cache=[(1, 512)])
    rng = np.random.RandomState(2)
    lens = []
    for _ in range(3):
        lx, ly = 60, 100
        out = eng.generate(rng.randint(1, 732, lx), rng.randint(0, 1024, ly),
                           np.zeros((lx, 1024), np.float32), top_k=15,
                           generator=torch.Generator().manual_seed(int(rng.randint(1e6))))
        lens.append(out.size)
    # geometric with a mean near 200 codes, capped by the 512-row cache (352 codes here)
    assert sum(n < 352 for n in lens) >= 2, lens
