"""A run of a tiny cell end to end on the CPU (the program's plain
versions), with its look for a card skipped: it is correct as it stands,
and not correct when the timed path is broken underneath it or when the
control (the score in bfloat16) takes the program's place. On a card, a
real cell through benchmark/run.py."""

import json
import os
import re
import subprocess
import sys

import pytest

from .helpers import ROOT, tiny_copy

DRIVER = r'''
import json, sys
sys.path.insert(0, %(root)r)
from benchmark import calibrate as C, run as R
from benchmark.harness.bench import Bench
from benchmark.harness.spec import Spec
from ngmlr_tpu_torch.out import sam

fault = %(fault)r
orig_read, orig_record = sam.SamWriter.write_read, sam.SamWriter._write_record

def pool_index(read):
    if read.name[:1] != b"r":
        return -1
    return int(read.name[1:].split(b"_")[0])

def write_read(self, read, records, mapped):
    # half of every batch left out: the odd pool reads never written
    if fault == "drop" and pool_index(read) >= 0 and pool_index(read) %% 2:
        return
    return orig_read(self, read, records, mapped)

def write_record(self, read, records, idx):
    # an answer altered where it is produced
    if pool_index(read) >= 0 and pool_index(read) %% 3 == 0:
        if fault == "shift":
            records[idx].local_pos += 1
        elif fault == "score":
            records[idx].score += 4.0
    return orig_record(self, read, records, idx)

sam.SamWriter.write_read, sam.SamWriter._write_record = write_read, write_record
# the fill's band cut to half its width, as benchmark/calibrate.py plants it
C.plant_faults()
C.ACTIVE["fault"] = {"narrow": "narrow50", "nosupp": "nosupp"}.get(fault,
                                                                "none")
spec = Spec(%(dest)r, %(dest)r + "/benchmark")
b = Bench(spec, %(cell)r, device="cpu")
rep = R.run(b, %(seed)d, %(seconds)f, False)
rep = dict(forbidden=R.forbidden_modules(), **rep)
print(json.dumps(rep))
'''


def run_tiny(tmp_path, fault=None, seed=2**31 + 5, seconds=3.0, sv=False):
    dest = tiny_copy(str(tmp_path), sv=sv)
    name = "tiny." + json.load(open(os.path.join(
        dest, "BENCHMARK.json")))["workloads"][0]["traffic"]
    code = DRIVER % dict(root=ROOT, fault=fault, dest=dest, cell=name,
                         seed=seed, seconds=seconds)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900,
                       env=dict(os.environ, NGMLR_TPU_WAVE_DEPTH="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


def test_tiny_cell_is_correct_and_loads_no_jax(tmp_path):
    rep, err = run_tiny(tmp_path, seconds=25.0)
    assert rep["correct"], (rep["checks"], err[-2000:])
    assert rep["forbidden"] == []
    assert rep["attempted"] > 0 and rep["failed"] == 0
    assert set(rep["metrics"]) == {"read_kbp_per_s", "read_latency_p95_s",
                                   "setup_s"}
    assert list(rep)[-1] == "checks"
    assert all(v == 0 for v, lim in rep["checks"].values() if lim == 0)


@pytest.mark.parametrize("fault,number", [("drop", "missing"),
                                          ("shift", "record_faults"),
                                          ("score", "score_gap"),
                                          ("narrow", "unaligned_share")])
def test_broken_timed_path_is_not_correct(tmp_path, fault, number):
    rep, _ = run_tiny(tmp_path, fault)
    assert not rep["correct"]
    assert (rep["failed"] > 0) == (number == "missing")
    value, limit = rep["checks"][number]
    assert value > limit


def test_control_in_bfloat16_is_not_correct(tmp_path):
    """The reference's score in bfloat16 put in the program's place fails
    the score limit (the same comparison the chip ran at the cells' size,
    benchmark/calibrate.py)."""
    sys.path.insert(0, ROOT)
    from benchmark.harness.bench import Bench
    from benchmark.harness.spec import Spec
    dest = tiny_copy(str(tmp_path))
    spec = Spec(dest, os.path.join(dest, "benchmark"))
    b = Bench(spec, "tiny.clr", device="cpu")
    b.setup()
    r = b.run(99, 2.0)
    b.free()
    nums, ctrl = b.judge(r, "bfloat16")
    limits = spec.limits("tiny.clr")
    assert all(nums[k] <= limits[k] for k in limits)
    assert ctrl["score_gap"] > limits["score_gap"]


@pytest.mark.cuda
def test_cell_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark",
                                                      "run.py"),
                        "--workload", "chr1_pacbio.clr", "--seed", "17",
                        "--seconds", "5", "--trace", "0"],
                       capture_output=True, text=True, timeout=1500,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    rep = json.loads(p.stdout.strip().splitlines()[-1])
    assert rep["correct"] and rep["device"]["platform"] == "gpu"


def _split_reads_judged(err: str) -> int:
    """The mapped reads of a kind that has to be split that the reference
    judged, from its notes."""
    m = re.findall(r"reference: (\d+) mapped reads of a kind in SPLIT_KINDS",
                   err)
    return int(m[-1]) if m else 0


def test_tiny_sv_cell_checks_split_reads(tmp_path):
    """SV reads (3-4 kb here, their events cut to fit) through a whole run
    on the CPU: sound records, each split read covering its pieces, none
    off its source. AS against the pieces' true paths (short_reads,
    score_deficit) is not held here: at these event sizes the breakpoints
    cost a larger share of a read than at svlong's."""
    rep, err = run_tiny(tmp_path, seconds=3.0, sv=True)
    assert rep["failed"] == 0 and rep["forbidden"] == []
    assert rep["attempted"] > 0 and _split_reads_judged(err) > 0, err[-2000:]
    checks = rep["checks"]
    for k in ("record_faults", "misplaced", "score_gap", "missing",
              "records_off_source", "unsplit_share", "unmapped_share",
              "unaligned_share"):
        assert checks[k][0] <= checks[k][1], (k, checks[k], err[-2000:])


def test_sv_reads_without_supplementary_records_are_not_correct(tmp_path):
    """The SAM writer dropping every supplementary record and SA tag (as
    benchmark/calibrate.py plants nosupp) fails unsplit_share."""
    rep, err = run_tiny(tmp_path, "nosupp", seconds=3.0, sv=True)
    assert _split_reads_judged(err) > 0, err[-2000:]
    assert not rep["correct"]
    value, limit = rep["checks"]["unsplit_share"]
    assert value > limit
