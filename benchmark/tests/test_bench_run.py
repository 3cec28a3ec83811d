"""The command's behaviour: the last line's shape, no run without a card,
no module of JAX or the JAX package, and a short run on the card."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, run

torch.set_num_threads(2)
ROOT = harness.ROOT
TINY = {"num_particles": 2048, "width": 64, "height": 64}
# a split run's records (`harness.run`), traced runs add "trace"
RECORD_KEYS = {"workload", "seed", "traced", "n", "force_model",
               "setup_phases_s", "setup_s", "window", "truncated",
               "numbers_first", "numbers_last", "reference_s", "smi",
               "result"}


def _tiny(workload="ap1m-split", trace=False):
    cfg = harness.cell(harness.spec(), workload)["config"]
    over = dict(TINY, check=dict(cfg["check"], rows=256))
    return harness.run(workload, 5, 0.3, trace, time.perf_counter(),
                       device="cpu", overrides=over)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    r = _tiny(trace=trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 1 and r["failed"] in (0, 1, 2)
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    c = harness.cell(harness.spec(), "ap1m-split")
    want = set(c["per_layer"] if trace else c["end_to_end"])
    assert set(r["metrics"]) <= want
    if not trace:      # on the CPU the device trace has nothing to read
        assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for k, c in r["checks"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(r)
    rec = json.loads((harness.RECORDS_DIR / "ap1m-split"
                      / f"seed5-trace{int(trace)}.json").read_text())
    assert rec["result"] == json.loads(json.dumps(r))
    assert set(rec) == RECORD_KEYS | ({"trace"} if trace else set())


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ap1m-split",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_no_result_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    gives no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.argv[1:] = ['--workload', 'ap1m-split', '--seed',"
         " '1', '--seconds', '1']; sys.path.insert(0, '.');"
         "import torch; torch.cuda.is_available = lambda: True;"
         "torch.cuda.device_count = lambda: 1;"
         "import runpy; runpy.run_path('benchmark/run.py',"
         " run_name='__main__')"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "multi_adapter_particles_torch" in proc.stderr


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen",
                 "multi_adapter_particles_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    monkeypatch.setitem(sys.modules, "multi_adapter_particles_torch.x",
                        object())
    bad = run.forbidden_modules()
    assert "jaxtyping" not in bad
    assert "multi_adapter_particles_torch.x" not in bad
    assert {"jax", "jax.numpy", "jaxlib", "flax.linen",
            "multi_adapter_particles_tpu.ops"} <= set(bad)


def test_a_run_loads_nothing_of_jax():
    """A whole run (CPU, tiny) in a fresh process, then its modules."""
    code = (
        "import sys, time, json; sys.path.insert(0, '.');"
        "import torch; torch.set_num_threads(2);"
        "from benchmark import harness, run;"
        "cfg = harness.config('ap-1m-1024');"
        "over = dict(num_particles=1024, width=32, height=32,"
        " check=dict(cfg['check'], rows=64));"
        "harness.run('ap1m-split', 3, 0.2, True, time.perf_counter(),"
        " device='cpu', overrides=over);"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "multi_adapter_particles_torch" in top
    assert not top & set(run.FORBIDDEN)


@pytest.mark.card
def test_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ap1m-split",
         "--seed", "77", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
