"""Nothing of the benchmark imports JAX or the JAX package; the reference
imports nothing of the program."""
import ast
from pathlib import Path

from harness import guard

BENCH = Path(__file__).resolve().parents[1]


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".", 1)[0])
    return out


def test_top_level_names_are_compared_whole():
    mods = {"gsv_tts_tpu_torch": 1, "gsv_tts_tpu_torch.tts": 1, "jaxtyping": 1, "numpy": 1}
    assert guard.forbidden_modules(mods) == []
    bad = {"gsv_tts_tpu": 1, "gsv_tts_tpu.models.t2s": 1, "jax": 1, "jax.numpy": 1,
           "jaxlib.xla_client": 1, "flax.linen": 1}
    assert guard.forbidden_modules(dict(mods, **bad)) == sorted(bad)


def test_no_source_under_the_benchmark_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not imported_tops(f) & set(guard.FORBIDDEN), f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        tops = imported_tops(f)
        assert "gsv_tts_tpu_torch" not in tops and "harness" not in tops, f


def test_a_run_without_a_card_exits_nonzero_with_no_result(capsys, monkeypatch):
    import torch

    from harness import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--workload", "v2-infer", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "no CUDA device" in out.err


def test_a_directory_without_the_program_fails(tmp_path):
    import os
    import shutil
    import subprocess
    import sys

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "v2-infer", "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
