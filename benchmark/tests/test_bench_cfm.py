"""The GPT-SoVITS v4 family (``families/cfm.py``) on the tiny CPU copy: a
sound run of ``v4-infer`` is correct and its numbers lie far inside the
float8 control's; planted faults (a chunk's noise replaced, one Euler step
dropped, the audio scaled) each come out not correct; ``dit_flops`` counts
what ``torch.utils.flop_counter`` counts of the reference's chunk; the three
v4 readers on a synthetic span log; the configuration came as files; a
program without a v4 stage is a ``RunError`` at once."""
import dataclasses
import json
import sys
import types

import numpy as np
import pytest
import torch

from harness import cli, spans

import tiny
import tiny_v4

SEED = "4400000019"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tiny_v4.install()
    return tiny.build(tmp_path_factory.mktemp("cfm"), window_requests=4)


def run(root, hooks=None, control=False):
    argv = ["--workload", "v4-infer", "--seed", SEED, "--seconds", "600", "--trace", "0"]
    return cli.run(argv + (["--control"] if control else []), root=root, require_cuda=False,
                   device="cpu", config_root=root / "benchmark", hooks=hooks)


def readings(err: str, prefix: str) -> dict:
    lines = [ln for ln in err.splitlines() if ln.startswith(prefix)]
    assert len(lines) == 1, lines
    return json.loads(lines[0][len(prefix):])


def test_a_sound_run_is_correct_and_the_control_is_far(root, capsys):
    res = run(root, control=True)
    err = capsys.readouterr().err
    assert res["correct"] is True
    got, ctl = readings(err, "readings "), readings(err, "control readings ")
    assert got["cfm_chunks_judged"] >= 2 * got["judged_requests"]  # several chunks a decode
    for k in ("cfm_mel_gap", "v4_audio_spec"):
        assert got[k] <= res["checked"][k][1]
    # float32 against float32: the mel to rounding, and the audio, vocoded by
    # the program at its frame bucket cut at the mel's frames and by the
    # reference at the mel's own length, to rounding
    assert got["cfm_mel_gap"] < 1e-5 and ctl["cfm_mel_gap"] > 1000 * got["cfm_mel_gap"]
    assert got["v4_audio_spec"] < 1e-5 and ctl["v4_audio_spec"] > 1000 * got["v4_audio_spec"]


def swapped_noise(c):
    """The program's CFM runs on other noise than the chunk's draw."""
    orig = c.tts._cfm_chunk

    def _cfm_chunk(sovits, fea, prompt_mel, noise):
        other = torch.randn(noise.shape, generator=torch.Generator().manual_seed(1))
        return orig(sovits, fea, prompt_mel, other.to(noise.device))
    c.tts._cfm_chunk = _cfm_chunk


def one_step_fewer(c):
    """The program's Euler loop runs one step fewer than the model's (its
    step tables made for steps − 1)."""
    from gsv_tts_tpu_torch.models import cfm

    sovits = c.tts.sovits_models[c.sovits_key]
    sovits.v4 = dataclasses.replace(sovits.v4, steps=sovits.v4.steps - 1)
    p = sovits.params
    p[cfm.PFX + "mods"], p[cfm.PFX + "final"] = cfm.modulations(p, sovits.v4.dit,
                                                               sovits.v4.steps)


def scaled_audio(c):
    """The vocoder's audio scaled where the facade makes it."""
    orig = c.tts._vocode_v4
    c.tts._vocode_v4 = lambda sovits, mel: orig(sovits, mel) * 0.5


@pytest.mark.parametrize("fault,number", [(swapped_noise, "cfm_mel_gap"),
                                          (one_step_fewer, "cfm_mel_gap"),
                                          (scaled_audio, "v4_audio_spec")],
                         ids=["noise-replaced", "31-steps-for-32", "audio-scaled"])
def test_a_planted_fault_is_not_correct(root, fault, number):
    res = run(root, hooks=fault)
    assert res["correct"] is False
    got, limit = res["checked"][number]
    assert got > limit


def test_dit_flops_counts_what_the_flop_counter_counts():
    from torch.utils.flop_counter import FlopCounterMode

    from reference import cfm_ref
    from gsv_tts_tpu_torch.models import cfm, sovits_v4

    fam = cli.load_family({"name": "gsv-v4-en", "sovits_family": "cfm"})
    widths = tiny_v4.TINY_DIT
    v4 = sovits_v4.V4Config.from_hps(tiny_v4.HPS_V4)
    p = {k: v for k, v in cfm.init_params(v4.dit, torch.Generator().manual_seed(3)).items()}
    T, P, steps = 57, 20, 3
    g = torch.Generator().manual_seed(4)
    fea, noise = torch.randn(1, widths["text_dim"], T, generator=g), torch.randn(1, 100, T)
    with FlopCounterMode(display=False) as fc:
        cfm_ref.cfm(p, dict(cfm_ref.DIT, **widths), fea, torch.randn(1, 100, P), noise, steps)
    assert fam.dit_flops(T, steps, widths) == fc.get_total_flops()
    # the published widths: ~0.47 TFLOP a forward over 1000 frames
    assert 4.5e11 < fam.dit_flops(1000, 1) < 5.0e11


class _Rec:
    def __init__(self, i, name, t0, t1, parent=None, request=None, seconds=None, **attrs):
        self.id, self.name, self.t0, self.t1, self.parent = i, name, t0, t1, parent
        self.request, self.attrs, self.events = request, attrs, None
        self.seconds = t1 - t0 if seconds is None else seconds


def test_the_v4_readers_on_a_synthetic_span_log(monkeypatch):
    """Two requests of the slice: 2 and 1 chunks of 1000 / 700 frames, the
    vocoder, on a log whose third request lies outside the slice."""
    log = []
    for req, (t, chunks, voc) in enumerate([(0.0, [(1000, 0.20), (700, 0.15)], 0.01),
                                            (1.0, [(1000, 0.25)], 0.02),
                                            (5.0, [(1000, 9.0)], 9.0)]):
        base = len(log)
        log.append(_Rec(base, "gsv.request.infer", t + 0.1, t + 0.9, request=req))
        log.append(_Rec(base + 1, "gsv.sovits.decode", t + 0.2, t + 0.8, base, req))
        for j, (frames, s) in enumerate(chunks):
            log.append(_Rec(base + 2 + j, "gsv.sovits.cfm", t + 0.3, t + 0.4, base + 1, req,
                            seconds=s, frames=frames, prompt=400, steps=32))
        log.append(_Rec(base + 5, "gsv.sovits.vocoder", t + 0.5, t + 0.6, base + 1, req,
                        seconds=voc))
    monkeypatch.setattr(spans, "records", lambda: log)
    ctx = types.SimpleNamespace(
        win={"t_open": 0.0}, cfg={"sovits_family": "cfm", "sovits": {"model": {}}},
        slice_requests=[{"t_call": 0.0, "t_done": 1.0, "audio_s": 10.0},
                        {"t_call": 1.0, "t_done": 2.0, "audio_s": 6.0}])
    fam = cli.load_family(ctx.cfg)
    audio, cfm_s = 16.0, 0.20 + 0.15 + 0.25
    assert cli.metric_reader("cfm_ms_per_audio_s.v4")(ctx) == pytest.approx(1000 * cfm_s / audio)
    assert cli.metric_reader("vocoder48_ms_per_audio_s.v4")(ctx) == pytest.approx(
        1000 * 0.03 / audio)
    flops = 2 * fam.dit_flops(1000, 32) + fam.dit_flops(700, 32)
    assert cli.metric_reader("cfm_mfu.v4")(ctx) == pytest.approx(100 * flops / (cfm_s * 989e12))
    monkeypatch.setattr(spans, "records", lambda: [])  # a program without the spans
    for name in ("cfm_ms_per_audio_s.v4", "vocoder48_ms_per_audio_s.v4", "cfm_mfu.v4"):
        assert cli.metric_reader(name)(ctx) is None


def test_v4_was_added_as_files():
    """The configuration, its family, tables, limits, readers and traffic are
    found by their names, with layouts that put the model and its vocoder in
    one ``sovits/`` directory; nothing but ``"sovits_family"`` tells the
    harness that the stage is not v2's."""
    from harness import traffic, weights

    bench = cli.load_bench(cli.HERE.parent)
    cell = cli.find_cell(bench, "v4-infer")
    cfg = cli.load_config(cell["config"])
    assert cfg["sovits_family"] == "cfm" and cfg["reduced"] == []
    assert cli.load_family(cfg).__name__ == "bench_family_cfm"
    assert traffic.load_mix(cell["traffic"])["voices"]["cached"] is True
    assert set(cli.load_limits("v4-infer")) >= {"t2s_gap", "cfm_mel_gap", "v4_audio_spec"}
    lays = {role: weights.layout(weights.leaf_table(part), part)
            for role, part in cfg["parts"].items()}
    assert lays["sovits"]["dir"] == lays["vocoder"]["dir"] == "sovits"
    assert lays["vocoder"]["file"] == "vocoder.pth" and lays["vocoder"]["meta_file"] is None
    for name in ("cfm_ms_per_audio_s.v4", "cfm_mfu.v4", "vocoder48_ms_per_audio_s.v4"):
        assert callable(cli.metric_reader(name))
        assert name in {m["name"] for m in cli.cell_metrics(bench, "v4-infer", "per_layer")}


def test_a_program_without_v4_is_a_run_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "gsv_tts_tpu_torch.models.sovits_v4", None)
    with pytest.raises(cli.RunError, match="no GPT-SoVITS v4"):
        cli.load_family({"name": "gsv-v4-en", "sovits_family": "cfm"})


def test_the_tiny_v4_copy_chunks_like_the_program(root):
    """The tiny configuration's chunking is the one ``tiny_v4`` states."""
    cfg = json.loads((root / "benchmark" / "configs" / "gsv-v4-en.json").read_text())
    m = cfg["sovits"]["model"]
    assert (m["t_ref"], m["t_chunk"], m["cfm_steps"]) == (50, 130, 4)
    assert np.prod(cfg["sovits"]["vocoder"]["upsample_rates"]) == 480
