"""What the benchmark imports: never JAX or the JAX package, and the
reference nothing of the program; the run fails rather than falling
back when there is no card."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import cells, run

BENCH = cells.BENCH_DIR
JAX_NAMES = {"jax", "jaxlib", "flax", "nhwcodec_tpu"}
# the yardstick: what decides correct, the inputs, the bounds, the
# controls; none of it may read the program
YARDSTICK = [BENCH / "reference", BENCH / "controls", BENCH / "check.py",
             BENCH / "images.py", BENCH / "roofline.py", BENCH / "trace.py"]


def _sources(paths):
    for p in paths:
        yield from ([p] if p.is_file() else sorted(p.rglob("*.py")))


def _top_names(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (absolute imports,
    and ``importlib.import_module`` of a constant)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    files = list(_sources([BENCH]))
    assert len(files) > 30
    bad = {str(f): _top_names(f) & JAX_NAMES for f in files
           if _top_names(f) & JAX_NAMES}
    assert not bad


def test_names_are_compared_whole():
    assert "nhwcodec_tpu" not in {"nhwcodec_tpu_torch"} & JAX_NAMES
    was = dict(sys.modules)
    try:
        sys.modules.pop("nhwcodec_tpu", None)
        sys.modules["nhwcodec_tpu_torch.x"] = sys.modules["json"]
        assert "nhwcodec_tpu" not in run.forbidden_modules()
        sys.modules["nhwcodec_tpu.models"] = sys.modules["json"]
        assert "nhwcodec_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(was)


def test_the_yardstick_imports_nothing_of_the_program():
    for f in _sources(YARDSTICK):
        names = _top_names(f)
        assert "nhwcodec_tpu_torch" not in names, f
        assert "torch" not in names, f


def test_the_reference_loads_no_program_module():
    code = ("import sys\n"
            "from benchmark import check, images, roofline\n"
            "from benchmark.controls import colorspace_f32, "
            "prefilter_skipped, yuv_to_rgb_bf16\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    loaded = set(json.loads(out.strip().replace("'", '"')))
    assert not loaded & (JAX_NAMES | {"nhwcodec_tpu_torch", "torch"})


def _run(cwd: Path, env=None):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "q8.enc.scans",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    """Without a CUDA card the run fails and prints nothing on standard
    output (in this sandbox, torch has no CUDA)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    r = _run(cells.ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "cuda" in r.stderr.lower()


def test_fewer_cards_than_the_cell_asks_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(os, "environ", dict(os.environ))
    rc = run.main(["--workload", "q8.enc.scans", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "needs 1 CUDA" in out.err


def test_bare_benchmark_directory_no_result(tmp_path):
    """A checkout of BENCHMARK.json and benchmark/ alone: no result."""
    shutil.copy(cells.SPEC, tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "*.so",
                                                  "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(tmp_path, env)
    assert r.returncode != 0 and r.stdout == ""
