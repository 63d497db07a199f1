"""The harness: cells, configurations and metrics found by name, the
result line's shape, the refusal without a card, and no JAX anywhere."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(harness.__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    """Top-level names a module imports (whole, before the first dot)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & FORBIDDEN, f
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert "repro_torch" not in _imports(f), f


def test_a_run_holds_no_forbidden_module():
    """Everything a run imports, the program's entry points included,
    leaves no ``jax``, ``jaxlib``, ``flax`` or ``repro`` module behind
    (``repro_torch`` is another name)."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from portbench import harness, serve, train, trace, check, limits\n"
        "from portbench.reference import train as rt\n"
        "import repro_torch.serving.engine, repro_torch.training.steps\n"
        "import repro_torch.kernels.ops, repro_torch.core.policies\n"
        "for m in harness.cell_metrics(harness.benchmark(), "
        "'mixtral-8x22b.chat', True):\n"
        "    harness.reader(m['name'])\n"
        "print(harness.forbidden_modules(), 'repro_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT / "src"),
                          str(ROOT)], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    try:
        assert "repro_torch_lookalike_for_test" not in \
            harness.forbidden_modules()
        assert set(harness.forbidden_modules()) <= FORBIDDEN
    finally:
        sys.modules.pop("repro_torch_lookalike_for_test", None)


def test_benchmark_names_resolve_to_files():
    b = harness.benchmark()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        cell = harness.load("workloads", w["name"])
        assert cell["config"] == w["config"]
        assert cell["chips"] == w["chips"] == 1
        assert cell["traffic"]["name"] == w["traffic"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for w in b["workloads"]:
        e2e = harness.cell_metrics(b, w["name"], False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.cell_metrics(b, w["name"], True)


def test_a_new_cell_and_metric_need_only_new_files(tmp_path, monkeypatch):
    """A copy of the benchmark plus one workload file, one metric file and
    their ``BENCHMARK.json`` entries: the harness finds both by name."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    cell = dict(harness.load("workloads", "mixtral-8x22b.chat"))
    cell["traffic"] = dict(cell["traffic"], name="chat-busy", rate_per_s=2.4)
    (root / "portbench" / "workloads" / "mixtral-8x22b.chat-busy.json"
     ).write_text(json.dumps(cell))
    (root / "portbench" / "metrics" / "requests_sent.py").write_text(
        "def read(run):\n    return float(len(run.outcomes))\n")
    bench["workloads"].append({"name": "mixtral-8x22b.chat-busy",
                               "config": "mixtral-8x22b",
                               "traffic": "chat-busy", "chips": 1,
                               "why": "past the knee"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_tokens_per_s":
            m["workloads"].append("mixtral-8x22b.chat-busy")
    bench["per_layer"].append({"name": "requests_sent", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "replica loop",
                               "moves": "serve_tokens_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", root / "portbench")
    monkeypatch.setattr(harness, "ROOT", root)
    w = harness.load("workloads", "mixtral-8x22b.chat-busy")
    assert w["traffic"]["rate_per_s"] == 2.4
    names = [m["name"] for m in harness.cell_metrics(
        harness.benchmark(), "mixtral-8x22b.chat-busy", True)]
    assert "requests_sent" in names and "optimizer_ms" not in names
    assert [m["name"] for m in harness.cell_metrics(
        harness.benchmark(), "mixtral-8x22b.chat-busy", False)] == \
        ["serve_tokens_per_s", "setup_s"]
    run = harness.Run("mixtral-8x22b.chat-busy", w, {}, "serve",
                      outcomes=[1, 2, 3])
    m = [x for x in harness.benchmark()["per_layer"]
         if x["name"] == "requests_sent"]
    assert harness.read_metrics(run, m) == {
        "requests_sent": {"value": 3.0, "unit": "requests"}}


def test_result_line_shape():
    line = harness.result_line(
        True, 10, 1, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 123}, {"mean_logit_gap": {"value": 0.1,
                                                        "limit": 0.5}},
        {"device_ops": [["k", 0.5]], "idle_gaps": [["decode_step", 0.1]]})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics",
                       "device", "breakdown", "checks"]
    assert d["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}
    assert "\n" not in line
    assert harness.checks_text(d["checks"]) == \
        "check mean_logit_gap: 0.1 limit 0.5"
    assert harness.percentile([5, 1, 4, 2, 3], 95) == 5
    assert harness.percentile(list(range(1, 101)), 95) == 95


@pytest.mark.parametrize("cell", ["mixtral-8x22b.chat", "qwen3-4b.train"])
def test_without_a_card_a_run_fails_and_prints_no_result(cell):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_an_unknown_cell_fails():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "no-such.cell",
         "--seed", "1", "--seconds", "1", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout.strip() == ""
