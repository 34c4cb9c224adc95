"""A run with its timed path broken underneath comes out not correct: the
card's look is skipped and the run drives the tiny copy on the CPU."""
import json

import numpy as np
import pytest

from harness import cli

import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("faults"), window_requests=4)


def run(root, cell, hooks=None):
    return cli.run(["--workload", cell, "--seed", "4200000011", "--seconds", "600",
                    "--trace", "0"], root=root, require_cuda=False, device="cpu",
                   config_root=root / "benchmark", hooks=hooks)


def test_a_sound_run_is_correct(root):
    res = run(root, "v2-infer")
    assert res["correct"] is True
    gap, limit = res["checked"]["t2s_gap"]
    assert gap <= limit


def altered_tokens(c):
    """A served code altered where the engine produces it."""
    orig = c.engine.generate

    def generate(*a, **kw):
        out = np.array(orig(*a, **kw))
        flat = out.reshape(-1)
        if flat.size > 3:
            flat[flat.size // 2] = (flat[flat.size // 2] + 1) % 1024
        return out
    c.engine.generate = generate


def altered_audio(c):
    """The SoVITS decode's audio altered where the facade produces it."""
    orig = c.tts._sovits_decode

    def _sovits_decode(*a, **kw):
        audio, attn = orig(*a, **kw)
        rng = np.random.RandomState(0)
        return audio + 0.5 * np.abs(audio).max() * rng.randn(*audio.shape), attn
    c.tts._sovits_decode = _sovits_decode


def altered_prompt_codes(c):
    """The prompt's HuBERT codes altered where the facade makes them."""
    orig = c.tts._get_prompt

    def _get_prompt(*a, **kw):
        codes = np.array(orig(*a, **kw))
        codes[::3] = (codes[::3] + 7) % 1024
        return codes
    c.tts._get_prompt = _get_prompt
    c.tts.prompt_audio_cache.clear()  # cached before the window: made again, altered


@pytest.mark.parametrize("cell,fault,number", [
    ("v2-infer", altered_tokens, "t2s_gap"),
    ("v2-infer", altered_audio, "sovits_spec"),
    ("v2pro-newvoice", altered_prompt_codes, "prompt_code_gap"),
])
def test_a_broken_path_is_not_correct(root, cell, fault, number):
    res = run(root, cell, fault)
    assert res["correct"] is False
    got, limit = res["checked"][number]
    assert got > limit


def test_the_float8_control_is_not_correct(root, capsys):
    """The control goes through the same verdict as the program.  The cell's
    limits are set for the published widths, where the float8 control reads
    far above them (PERF.md section 2); at these tiny widths it reads
    t2s_gap about 0.09 and sovits_spec about 0.05, against 0 and 0.01 for
    the program on the CPU, so the test holds both to limits between those
    readings.  The control then comes out not correct and the run prints
    its result; with limits above the control's readings the run exits
    with 4 and prints nothing."""
    argv = ["--workload", "v2-infer", "--seed", "4200000013", "--seconds", "600",
            "--trace", "0", "--control"]
    kw = dict(root=root, require_cuda=False, device="cpu", config_root=root / "benchmark")
    limits = root / "benchmark" / "limits" / "v2-infer.json"
    kept = limits.read_text()
    try:
        limits.write_text(json.dumps({"limits": {"t2s_gap": 0.03, "sovits_spec": 0.02}}))
        assert cli.main(argv, **kw) == 0
        out, err = capsys.readouterr()
        assert "control correct: false" in err
        assert json.loads(out.strip().splitlines()[-1])["correct"] is True
        limits.write_text(json.dumps({"limits": {"t2s_gap": 1e9, "sovits_spec": 1e9}}))
        assert cli.main(argv, **kw) == 4
        out, err = capsys.readouterr()
        assert out == "" and "control correct: true" in err
    finally:
        limits.write_text(kept)
