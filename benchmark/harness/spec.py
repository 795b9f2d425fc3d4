"""BENCHMARK.json and the files it names, found by name:

  benchmark/configs/<config>.json    a deployment: its argv, genome, scoring
  benchmark/traffic/<traffic>.json   a traffic mix (harness/gen.py reads it)
  benchmark/limits/<cell>.json       the limits of a cell's checks
  benchmark/metrics/<metric>.py      a metric's reader: read(run) -> value
                                     or None where it finds nothing to read
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class Spec:
    def __init__(self, root: str = ROOT, bench_dir: str = HERE):
        self.root = root
        self.dir = bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def _path(self, *parts):
        return os.path.join(self.dir, *parts)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload %r in BENCHMARK.json" % name)

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError("no config %r in BENCHMARK.json" % name)

    def mix(self, name: str) -> dict:
        with open(self._path("traffic", name + ".json")) as f:
            return json.load(f)

    def limits(self, cell: str) -> dict:
        with open(self._path("limits", cell + ".json")) as f:
            return json.load(f)

    def metrics_for(self, cell: str, trace: bool):
        """The cell's end-to-end metrics (trace off) or per-layer ones."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self._path("metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
