"""A tiny copy of the benchmark for runs on the CPU: a 2 Mbp genome, short
reads, 16-read batches, the real metric readers and limits."""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


# svlong's reads (scripts/torch_scale_vs_jax.py: SV_LEN, SV_KINDS,
# SV_SIZES, JOIN_MIN): a mix that tests the read model and the reference
# on reads that span structural variants; no cell of the benchmark runs it
SV_LENGTH = {"dist": "uniform", "lo": 10_000, "hi": 40_000}
SV_EVENTS = {"kinds": ["clean", "del", "ins", "inv", "dup", "join"],
             "sizes": {"del": [1_000, 20_000], "ins": [500, 5_000],
                       "inv": [1_000, 10_000], "dup": [1_000, 10_000]},
             "join_min": 1_000_000}


def sv_mix() -> dict:
    """The clr mix's noise and strands over svlong's SV reads."""
    with open(os.path.join(BENCH, "traffic", "clr.json")) as f:
        mix = json.load(f)
    return dict(mix, length=dict(SV_LENGTH), events=json.loads(
        json.dumps(SV_EVENTS)))


def tiny_copy(dest: str, cell="chr1_pacbio.clr", mean_length=3000,
              sv=False) -> str:
    """dest/BENCHMARK.json and dest/benchmark/ (configs, traffic, limits,
    metrics), cut to one cell `tiny.<traffic>` that runs in seconds on the
    CPU. With sv, the cell's reads span structural variants (svlong's
    kinds, 3-4 kb here, their events cut to fit) and its limits also hold
    unsplit_share and records_off_source. Returns dest."""
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
    with open(os.path.join(b, "limits", cell + ".json")) as f:
        limits = json.load(f)
    tp = os.path.join(b, "traffic", w["traffic"] + ".json")
    with open(tp) as f:
        mix = json.load(f)
    mix["length"] = dict(mix["length"], mean=mean_length,
                         sd=mean_length // 4, min=500)
    if sv:
        mix["length"] = {"dist": "uniform", "lo": 3000, "hi": 4000}
        mix["events"] = dict(SV_EVENTS, join_min=500_000, sizes={
            "del": [300, 1000], "ins": [200, 600], "inv": [300, 1000],
            "dup": [300, 500]})
        limits.update(unsplit_share=10.0, records_off_source=0)
    with open(os.path.join(b, "limits", name + ".json"), "w") as f:
        json.dump(limits, f)
    mix.update(warmup_batches=1, pool_max_reads=60, check_share=1.0)
    with open(tp, "w") as f:
        json.dump(mix, f)
    return dest
