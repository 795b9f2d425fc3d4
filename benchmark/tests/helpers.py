"""A tiny copy of the benchmark for runs on the CPU: a 2 Mbp genome, short
reads, 16-read batches, the real metric readers and limits."""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


def tiny_copy(dest: str, cell="chr1_pacbio.clr", mean_length=3000) -> str:
    """dest/BENCHMARK.json and dest/benchmark/ (configs, traffic, limits,
    metrics), cut to one cell `tiny.<traffic>` that runs in seconds on the
    CPU. Returns dest."""
    b = os.path.join(dest, "benchmark")
    for d in ("traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(b, d))
    os.makedirs(os.path.join(b, "configs"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    w = next(x for x in spec["workloads"] if x["name"] == cell)
    c = next(x for x in spec["configs"] if x["name"] == w["config"])
    with open(os.path.join(ROOT, c["file"])) as f:
        conf = json.load(f)
    conf["genome"] = dict(conf["genome"], length=2_000_000, seed=7)
    conf["argv"] = [a for a in conf["argv"]] + ["--batch-reads", "16"]
    with open(os.path.join(b, "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    name = "tiny." + w["traffic"]
    spec["configs"] = [dict(c, name="tiny", file="benchmark/configs/tiny.json")]
    spec["workloads"] = [dict(w, name=name, config="tiny")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [name]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    shutil.copy(os.path.join(b, "limits", cell + ".json"),
                os.path.join(b, "limits", name + ".json"))
    tp = os.path.join(b, "traffic", w["traffic"] + ".json")
    with open(tp) as f:
        mix = json.load(f)
    mix["length"] = dict(mix["length"], mean=mean_length,
                         sd=mean_length // 4, min=500)
    mix.update(warmup_batches=1, pool_max_reads=60, check_share=1.0)
    with open(tp, "w") as f:
        json.dump(mix, f)
    return dest
