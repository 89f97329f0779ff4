"""The benchmark's layout: cells, configurations, mixes and metrics found
by name as new files; no JAX anywhere under the folder; the reference
free of the program (CPU)."""

from __future__ import annotations

import ast
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from harness import weights  # noqa: E402
from harness.cells import Bench  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "lumen_tpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_nothing_under_the_folder_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = _imports(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    # compared whole: the port's name begins with the JAX package's
    assert "lumen_tpu_torch" not in FORBIDDEN and "lumen_tpu_torch".split(".")[0] != "lumen_tpu"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not {n for n in _imports(path) if n.startswith("lumen")}, path
        assert "lumen_tpu_torch" not in path.read_text()


def test_benchmark_json_names_files_that_exist():
    bench = Bench()
    spec = bench.spec
    for c in spec["configs"]:
        cfg = bench.config(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert c["reduced"] == [] and cfg["name"] == c["name"]
    metric_names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    for w in spec["workloads"]:
        bench.traffic(w["traffic"])
        assert bench.cell(w["name"])["sample"]["min_tokens"] > 0
        e2e = {m["name"] for m in bench.metrics_for(w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = bench.metrics_for(w["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)
    for name in metric_names:
        assert callable(bench.reader(name))


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    folder = tmp_path / "benchmark"
    shutil.copytree(BENCH, folder, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "qwen1.5-moe-a2.7b-vlm.json").read_text())
    cfg["name"] = "other-vlm"
    (folder / "configs" / "other-vlm.json").write_text(json.dumps(cfg))
    (folder / "traffic" / "other-mix.json").write_text(json.dumps(
        {"loop": "closed", "clients": 2, "prompt_words": [4, 8], "max_tokens": [8, 8], "mix": 4}))
    (folder / "cells" / "other-cell.json").write_text(json.dumps(
        {"sample": {"min_tokens": 10, "max_requests": 2}, "limits": {"gap_max": 1.0, "gap_mean": 0.1}}))
    (folder / "metrics" / "other_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    spec["configs"].append({"name": "other-vlm", "source": "https://example.org", "file":
                            "benchmark/configs/other-vlm.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "other-cell", "config": "other-vlm", "traffic": "other-mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "other_metric", "unit": "%", "better": "higher", "source": "host_clock",
                              "layer": "Device", "moves": "setup_s", "workloads": ["other-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(root=tmp_path, folder=folder)
    assert bench.config(bench.workload("other-cell")["config"])["name"] == "other-vlm"
    assert bench.traffic("other-mix")["clients"] == 2
    assert bench.cell("other-cell")["limits"]["gap_max"] == 1.0
    assert [m["name"] for m in bench.metrics_for("other-cell", True)] == ["other_metric"]
    assert bench.reader("other_metric")(None) == 42.0
    # the cells already there are untouched by the new one
    assert "other_metric" not in [m["name"] for m in bench.metrics_for("moe-caption-long", True)]


def test_weights_follow_the_published_sizes():
    moe = json.loads((BENCH / "configs" / "qwen1.5-moe-a2.7b-vlm.json").read_text())
    # Qwen1.5-MoE-A2.7B is 14.3B parameters
    decoder = sum(math.prod(s) for n, s, _, _ in weights.specs(moe) if n.startswith("decoder."))
    assert decoder == pytest.approx(14.3e9, rel=0.01)


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "moe-caption-long", "--seed", str(2**33 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.card
def test_card(card):
    """On the card: one short run of the cell prints the contract's line."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "moe-caption-long", "--seed", str(2**33 + 7),
         "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "checks" and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"tok_s", "setup_s"}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card (a CUDA device)")
