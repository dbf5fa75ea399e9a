"""The command from the root of a checkout: no card means no result and
another exit code than 0; a directory that holds only the benchmark fails
the same way; nothing a run imports is JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness, run

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_viterbi"}
ARGS = ["--workload", "soft8-rx32m", "--seed", "3000000000", "--seconds",
        "1", "--trace", "0"]


def _python(code, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    """Here torch finds no card: the run neither falls back to the CPU nor
    prints a result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    res = subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 3
    assert res.stdout.strip() == ""
    assert "needs 1 CUDA card" in res.stderr


def test_unknown_workload():
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 2


def test_only_the_benchmark_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files but not
    the program: the run stops before a result, on the CPU as on a card."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _python("import sys; from benchmark import run; "
                  f"sys.exit(run.main({ARGS!r}, device='cpu'))",
                  cwd=tmp_path)
    assert res.returncode == 5, res.stderr
    assert res.stdout.strip() == ""
    res = subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_run_imports_no_jax():
    """Every module a run imports (the harness, both kinds and with them
    the program, every metric), compared by whole top-level names."""
    res = _python(
        "import json, sys\n"
        "from benchmark import run, trace, rooflines, reference\n"
        "from benchmark.kinds import rx, sim\n"
        "from benchmark.harness import BENCH_DIR\n"
        "for p in (BENCH_DIR / 'metrics').glob('*.py'):\n"
        "    run.metric_reader(p.stem) if p.stem != '__init__' else None\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert res.returncode == 0, res.stderr
    loaded = set(json.loads(res.stdout))
    assert "tpu_viterbi_torch" in loaded
    assert not loaded & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_viterbi_torchx", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_viterbi.config", sys)
    assert run.forbidden_modules() == ["tpu_viterbi"]


@pytest.mark.parametrize("where", ["check", "metric"])
def test_jax_loaded_after_the_window_no_result(capsys, monkeypatch, where):
    """A module named ``jax`` that the comparison or a per-layer metric's
    reader loads, after the window has closed, still stops the result."""
    from benchmark import reference

    def plant():
        sys.modules["jax"] = types.ModuleType("jax")

    if where == "check":
        decode = reference.decode

        def planting_decode(*a, **k):
            plant()
            return decode(*a, **k)
        monkeypatch.setattr(reference, "decode", planting_decode)
    else:
        reader = run.metric_reader

        def planting_reader(name):
            read = reader(name)

            def planting_read(*a):
                plant()
                return read(*a)
            return planting_read
        monkeypatch.setattr(run, "metric_reader", planting_reader)
    assert "jax" not in sys.modules
    try:
        rc = run.main(["--workload", "soft8-rx1m", "--seed", "6",
                       "--seconds", "0.2", "--trace",
                       "1" if where == "metric" else "0"], device="cpu",
                      overrides={"message_bits": 4000, "ring": 2,
                                 "warmup_calls": 1, "sample": 2,
                                 "trace_calls": 2})
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert rc == 4
    assert out.out.strip() == ""
    assert "loaded once the window closed: jax" in out.err


@pytest.mark.parametrize("name", ["reference.py", "reference_stream.py",
                                  "framing.py", "rooflines.py", "trace.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    """The reference and the yardstick import torch, numpy, the standard
    library and each other only."""
    tree = ast.parse((ROOT / "benchmark" / name).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & (FORBIDDEN | {"tpu_viterbi_torch"})
    res = _python(f"import sys, benchmark.{name[:-3]}; "
                  "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert res.returncode == 0 and "tpu_viterbi" not in res.stdout


@pytest.mark.cuda
def test_cell_on_the_card():
    """A short run of the smallest cell on the card is correct and
    reports its metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "soft8-rx1m",
         "--seed", "11", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"decode_gbps", "decode_p95_ms",
                                      "setup_s"}
    assert result["device"]["platform"] == "gpu"
