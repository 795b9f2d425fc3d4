"""Configurations, mixes, limits and metrics are found by their names: a
new file and a new entry in BENCHMARK.json are enough."""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np

from benchmark.harness.spec import Spec

from .helpers import BENCH, ROOT


def _copy(tmp_path):
    dest = tmp_path / "root"
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    return dest


def test_every_name_in_benchmark_json_has_its_files():
    spec = Spec()
    for c in spec.data["configs"]:
        conf = spec.config(c["name"])
        assert conf["name"] == c["name"]
        assert all(k in conf for k in c["reduced"])
    for w in spec.data["workloads"]:
        spec.mix(w["traffic"])
        assert set(spec.limits(w["name"])) >= {"record_faults", "misplaced",
                                               "score_gap", "missing"}
        for trace in (False, True):
            for m in spec.metrics_for(w["name"], trace):
                assert callable(spec.reader(m["name"]))


def test_new_cell_mix_and_metric_found_without_edits(tmp_path):
    dest = _copy(tmp_path)
    b = dest / "benchmark"
    (b / "metrics" / "reads_finished.py").write_text(
        "def read(run):\n    return len(run.bases) or None\n")
    mix = json.loads((b / "traffic" / "clr.json").read_text())
    mix["length"] = {"dist": "uniform", "lo": 1000, "hi": 20000}
    (b / "traffic" / "wide.json").write_text(json.dumps(mix))
    (b / "limits" / "chr1_pacbio.wide.json").write_text(
        (b / "limits" / "chr1_pacbio.clr.json").read_text())
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "chr1_pacbio.wide",
                              "config": "chr1_pacbio", "traffic": "wide",
                              "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "reads_finished", "unit": "reads",
                              "better": "higher", "source": "host_clock",
                              "layer": "pipeline", "moves": "read_kbp_per_s",
                              "workloads": ["chr1_pacbio.wide"]})
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    s = Spec(str(dest), str(b))
    assert s.mix("wide")["length"]["hi"] == 20000
    assert s.cell("chr1_pacbio.wide")["traffic"] == "wide"
    names = [m["name"] for m in s.metrics_for("chr1_pacbio.wide", True)]
    assert "reads_finished" in names
    assert "reads_finished" not in [
        m["name"] for m in s.metrics_for("chr1_pacbio.clr", True)]
    run = SimpleNamespace(bases=np.array([5, 6]))
    assert s.reader("reads_finished")(run) == 2
    assert s.reader("reads_finished")(SimpleNamespace(bases=[])) is None


def test_metric_without_a_reading_is_left_out():
    spec = Spec()
    run = SimpleNamespace(trace=None, seconds=10.0, mbp=0.0,
                          bases=np.zeros(0), latencies=np.zeros(0))
    for name in ("convex_fill_roofline", "device.idle_share",
                 "search.s_per_Mbp", "read_latency_p95_s"):
        assert spec.reader(name)(run) is None

