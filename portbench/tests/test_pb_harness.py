"""The harness: roofline counts from shapes, the trace's idle share, the
result's last line, discovery by name (a cell added from new files alone),
and what makes a run refuse to report."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench import roofline, run, trace
from portbench.reference import nucleotide, signal
from portbench.tests.small import SMALL, bench, run_small

ROOT = Path(__file__).resolve().parents[2]


def test_roofline_counts_from_shapes():
    # threeState: 8 edges of 2 terms, 3 of them middle edges
    assert roofline.ops_per_cell("forward", signal.EDGES, 3) == 8 * 16
    assert roofline.ops_per_cell("backward", signal.EDGES, 3) == 128 + 48 + 33 + 4 + 7
    em = roofline.ops_per_cell("backward_em", signal.EDGES, 3, wgroups=((0, 1, 2),))
    assert em == 220 + 8 * 8 + 5 + 1
    assert roofline.pipeline_ops_per_cell(signal.EDGES, 3, "signal", em=True,
                                          wgroups=((0, 1, 2),)) == 28 + 128 + em
    # fiveState: 13 edges, 5 middle, symbol emissions are lookups
    assert roofline.pipeline_ops_per_cell(nucleotide.EDGES, 5, "symbol", em=False) == \
        13 * 16 + (13 * 16 + 5 * 16 + 55 + 4 + 7)
    b = roofline.job_bytes(100, 200, 301, 3, 5000, em=False)
    assert b == (13 * 100 + 2 * 200) * 4 + 8 * 4 * 301 + 24 + 4 * 5000
    assert roofline.job_bytes(100, 200, 301, 3, 5000, em=True) == b - 4 * 5000
    assert roofline.least_seconds(67e12, 1.0) == (1.0, "operations")
    assert roofline.least_seconds(1.0, 3.35e12) == (1.0, "bytes")
    assert roofline.pipeline_seconds({"void recursion_kernel<true, 3>(...)": 2.0,
                                      "epilogue_kernel<1>": 1.0, "aten::copy_": 5.0}) == 3.0


def test_idle_share_from_profiler_events():
    ev = [("device", "k1", 1.0, 2.0), ("device", "k2", 1.5, 3.0), ("device", "k1", 5.0, 6.0),
          ("device", "outside", 20.0, 21.0), ("span", "prep", 3.0, 4.5),
          ("span", "decode", 4.5, 9.0)]
    r = trace.reduce(ev, (0.0, 10.0))
    assert r["busy_s"] == pytest.approx(3.0) and r["window_s"] == 10.0
    assert dict(r["device_ops"]) == pytest.approx({"k1": 2.0, "k2": 1.5})
    idle = dict(r["idle_gaps"])
    assert idle == pytest.approx({"prep": 1.5, "decode": 3.5, "outside spans": 2.0})
    assert r["device_ops"][0][0] == "k1"


def test_spans_add_up_per_name():
    s = trace.Spans(traced=False)
    for _ in range(3):
        with s("a"):
            pass
    assert set(s.seconds) == {"a"} and s.seconds["a"] >= 0


@pytest.mark.parametrize("trace_on", [0, 1])
def test_last_line_shape(trace_on):
    rc, res = run_small("sigalign.reads", trace=trace_on)
    assert rc == 0
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in res) == bool(trace_on)
    json.loads(json.dumps(res))
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    if trace_on:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        names = {m["name"] for m in bench()["per_layer"]}
        assert set(res["metrics"]) <= names
    else:
        assert set(res["metrics"]) == {"events_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_every_entry_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        spec = run.cell_spec(bench, w["name"])
        assert (run.BENCH_DIR / "drivers" / f"{spec['traffic']['driver']}.py").exists()
        assert spec["per_layer"] and spec["end_to_end"]
    for m in bench["per_layer"]:
        mod = run.load_module(run.BENCH_DIR / "metrics" / f"{m['name']}.py")
        assert mod.read({}) is None


def test_a_cell_from_new_files_alone(tmp_path):
    """A copy of the benchmark gains a mix, a limits file, a per-layer metric
    and their entries (with the alignment rate, as ``sigalign.reads`` would
    come back), and runs the new cell without any file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(ROOT / "cpecan_signal_tpu_torch", root / "cpecan_signal_tpu_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["end_to_end"] += json.loads((ROOT / "portbench/tests/reads_cell.json").read_text()
                                      )["end_to_end"]
    mix = dict(json.loads((ROOT / "portbench/traffic/align_64_of_128.json").read_text()),
               **SMALL["sigalign.reads"][0])
    (root / "portbench/traffic/align_tiny.json").write_text(json.dumps(mix))
    (root / "portbench/limits/sigalign.tiny.json").write_text(
        (ROOT / "portbench/limits/sigalign.reads.json").read_text())
    (root / "portbench/metrics/align.calls.py").write_text(
        "def read(readings):\n    return readings.get('calls')\n")
    bench["workloads"].append({"name": "sigalign.tiny", "config": "signalalign_threestate_6mer",
                               "traffic": "align_tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "align.calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "a test",
                               "moves": "events_per_s", "workloads": ["sigalign.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, torch; sys.path.insert(0, '.');"
            "from portbench import run;"
            "rc, res = run.run(['--workload', 'sigalign.tiny', '--seed', '8', '--seconds', '0.1',"
            " '--trace', '1'], device=torch.device('cpu'));"
            "print(json.dumps(res))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["align.calls"]["value"] >= 1


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, res = run.run(["--workload", "sigalign.em", "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
    assert rc != 0 and res is None


def test_refuses_with_jax_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res = run_small("sigalign.reads")
    assert rc != 0 and res is None


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sigalign.em",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and not out.stdout.strip()


def test_a_run_loads_no_jax():
    """What a run imports, the port's modules the drivers call included,
    holds no module whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole)."""
    code = ("import sys; sys.path.insert(0, '.');"
            "from portbench import run, control, trace, readers, roofline;"
            "from pathlib import Path;"
            "[run.load_module(p) for d in ('drivers', 'metrics') "
            " for p in sorted(Path('portbench', d).glob('*.py'))];"
            "import cpecan_signal_tpu_torch.cli.realign, cpecan_signal_tpu_torch.cli.vanilla_align;"
            "import cpecan_signal_tpu_torch.em.sm3_em, cpecan_signal_tpu_torch.engine.batch_align;"
            "bad = {m.split('.')[0] for m in sys.modules} & set(run.FORBIDDEN);"
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


@pytest.mark.cuda
def test_a_small_run_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import run as r
    for w, (traffic, config) in SMALL.items():
        rc, res = r.run(["--workload", w, "--seed", "12", "--seconds", "1", "--trace", "1"],
                        device=torch.device("cuda", 0), overrides=traffic,
                        config_overrides=config, bench=bench())
        assert rc == 0 and res["correct"], (w, res)
