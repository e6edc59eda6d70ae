"""The harness finds a configuration, a traffic mix and a metric that
are added as files only, by the names in BENCHMARK.json."""

import json
import shutil
import subprocess
import sys

from perfbench.tests.conftest import ROOT
from perfbench.tests.small import bench


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "grade-4k.json").read_text())
    cfg.update(name="grade-tiny", width=40, height=24)
    (pb / "configs" / "grade-tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "ctx-16.json").read_text())
    tr.update(streams=2, warm_rounds=1, check_frames=4)
    (pb / "traffic" / "ctx-2.json").write_text(json.dumps(tr))
    (pb / "metrics" / "frames_pushed.py").write_text(
        "def read(rec):\n    return rec.attempted\n")
    b = bench()
    b["configs"].append({"name": "grade-tiny", "source": "test",
                         "file": "perfbench/configs/grade-tiny.json",
                         "reduced": ["width", "height"], "why": "test"})
    b["workloads"].append({"name": "grade-tiny.ctx-2",
                           "config": "grade-tiny", "traffic": "ctx-2",
                           "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "frames_pushed", "unit": "frames",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["grade-tiny.ctx-2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = f"""
import json, sys, time
from pathlib import Path
sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
from perfbench import harness
assert harness.HERE == Path({str(pb)!r})
cell = harness.load_cell(json.loads(Path("BENCHMARK.json").read_text()),
                         "grade-tiny.ctx-2", Path("."), seed=3,
                         seconds=0.3, device="cpu", born=time.perf_counter())
rec, ok = harness.run(cell)
print(json.dumps(harness.result_line(cell, rec, {{}})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert line["metrics"]["frames_pushed"]["value"] == line["attempted"]
    assert set(line["metrics"]) == {"setup_s", "frames_pushed"}
