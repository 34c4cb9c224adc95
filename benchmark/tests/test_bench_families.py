"""The v2 family's numbers did not move when the SoVITS stage became a
family module: at one seed on the tiny copy, both cells' readings and the
float8 control's equal those that the harness printed before the move
(``harness/cli.py`` recording, warming and judging the VITS decode
itself), recorded by the same ``--control`` run on the same copy."""
import json

import pytest

from harness import cli

import tiny

SEED = "4300000017"
BEFORE = {
    "v2-infer": (
        {"t2s_gap": 0.0, "t2s_positions": 1305, "t2s_flip_share": 0.0, "prompt_code_gap": 0.0,
         "prompt_code_gap_mean": 0.0, "prompt_code_mismatch": 0.0,
         "sovits_err": 0.008020216441048554, "sovits_spec": 0.009455201205940981,
         "judged_requests": 3},
        {"t2s_gap": 0.09270358085632324, "t2s_positions": 1305,
         "t2s_flip_share": 0.05823754789272031, "prompt_code_gap": 0.0022025443613529205,
         "prompt_code_gap_mean": 7.617517104862552e-05,
         "prompt_code_mismatch": 0.05263157894736842, "sovits_err": 0.050197453303432255,
         "sovits_spec": 0.046927057691231955}),
    "v2pro-newvoice": (
        {"t2s_gap": 0.0, "t2s_positions": 968, "t2s_flip_share": 0.0, "prompt_code_gap": 0.0,
         "prompt_code_gap_mean": 0.0, "prompt_code_mismatch": 0.0,
         "sv_emb_err": 9.07667159082507e-08, "sovits_err": 0.031159656291064913,
         "sovits_spec": 0.013472883195415739, "judged_requests": 3},
        {"t2s_gap": 0.09829902648925781, "t2s_positions": 968,
         "t2s_flip_share": 0.05578512396694215, "prompt_code_gap": 0.005885530263185501,
         "prompt_code_gap_mean": 0.00016814719022410673,
         "prompt_code_mismatch": 0.0975609756097561, "sv_emb_err": 0.020503887208323173,
         "sovits_err": 0.14039562042468393, "sovits_spec": 0.07098315061826391}),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("families"), window_requests=4)


def readings(err: str, prefix: str) -> dict:
    lines = [ln for ln in err.splitlines() if ln.startswith(prefix)]
    assert len(lines) == 1, lines
    return json.loads(lines[0][len(prefix):])


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_vits_numbers_equal_the_parents(root, cell, capsys):
    res = cli.run(["--workload", cell, "--seed", SEED, "--seconds", "600", "--trace", "0",
                   "--control"], root=root, require_cuda=False, device="cpu",
                  config_root=root / "benchmark")
    err = capsys.readouterr().err
    want, want_ctl = BEFORE[cell]
    got, got_ctl = readings(err, "readings "), readings(err, "control readings ")
    # the same keys in the same order: the printed lines read as before
    assert list(got) == list(want) and list(got_ctl) == list(want_ctl)
    # equal to float32 rounding (the CPU's thread count moves the last digits)
    assert got == pytest.approx(want, rel=1e-5, abs=1e-9)
    assert got_ctl == pytest.approx(want_ctl, rel=1e-5, abs=1e-9)
    assert {k: v[0] for k, v in res["checked"].items()} == \
        pytest.approx({k: want[k] for k in res["checked"]}, rel=1e-5, abs=1e-9)
