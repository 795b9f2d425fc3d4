"""The port's benchmark scripts on the CPU: scripts/torch_bench.py against
bench.py and ngmlr_tpu's Pipeline, and scripts/torch_bench_prep.py.

Each test runs the scripts in subprocesses with TMPDIR set to its own
tmp_path (the benches' work directories live under tempfile.gettempdir())
at a pinned tiny scale: a 0.2 Mbp genome, 8 timed reads and 2 warmup reads
of ~2 kb.
"""

import glob
import importlib.util
import io
import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "scripts", "torch_bench.py")
PREP = os.path.join(REPO, "scripts", "torch_bench_prep.py")
MBP = 0.2
SCALE = {"BENCH_GENOME_MBP": str(MBP), "BENCH_READS": "8",
         "BENCH_WARMUP": "2", "BENCH_READ_LEN": "2000"}
WORKDIR = "ngmlr_bench_g0.2_r2000_n8_w2"
# bench.py's keys, then the card's facts the port adds
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "genome_mbp",
              "n_reads", "pass_s", "gcups_convex_dp", "gcups_convex_dp_padded",
              "stage_split_s", "stage_counts", "host_other_s")
CARD_KEYS = ("device", "peak_device_bytes", "setup_s", "kernel_launches",
             "mapped_frac")


def _env(tmp, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") and k != "NGMLR_TORCH_DEVICE"}
    env.update(SCALE, TMPDIR=str(tmp), OMP_NUM_THREADS="1", **extra)
    return env


def _run(argv, env, timeout=120):
    return subprocess.run([sys.executable] + argv, cwd=REPO, env=env,
                          capture_output=True, timeout=timeout)


def _one_line(proc):
    """The bench's stdout must be exactly one JSON line."""
    lines = proc.stdout.decode().splitlines()
    assert len(lines) == 1, (lines, proc.stderr.decode()[-2000:])
    return json.loads(lines[0])


def _prepare(module, path, tmp):
    """Run `module`.prepare_workdir at the pinned scale with TMPDIR=tmp;
    returns the work directory it wrote."""
    code = ("import sys; sys.path.insert(0, %r); import %s; "
            "print(%s.prepare_workdir(%r)[0])" % (path, module, module, MBP))
    proc = _run(["-c", code], _env(tmp))
    assert proc.returncode == 0, proc.stderr.decode()
    return proc.stdout.decode().strip()


def _cache_ready(tmp):
    code = ("import sys; sys.path.insert(0, %r); import torch_bench; "
            "print(torch_bench.cache_ready(%r))"
            % (os.path.join(REPO, "scripts"), MBP))
    proc = _run(["-c", code], _env(tmp))
    assert proc.returncode == 0, proc.stderr.decode()
    return proc.stdout.decode().strip() == "True"


def test_prepare_workdir_writes_bench_py_fastas(tmp_path):
    """Same seed, same draws, same work directory name: the port's bench
    maps the very files bench.py maps."""
    ours = _prepare("torch_bench", os.path.join(REPO, "scripts"),
                    tmp_path / "port")
    ref = _prepare("bench", REPO, tmp_path / "jax")
    assert os.path.basename(ours) == os.path.basename(ref) == WORKDIR
    for name in ("ref.fa", "reads.fa", "warmup.fa"):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


def test_cpu_line_matches_the_jax_pipeline(tmp_path):
    """NGMLR_TORCH_DEVICE=cpu, one pass: one line with bench.py's keys and
    the card's facts, and the problem and mapped counts of ngmlr_tpu's
    Pipeline on the same files."""
    proc = _run([BENCH], _env(tmp_path, NGMLR_TORCH_DEVICE="cpu",
                              BENCH_PASSES="1"))
    line = _one_line(proc)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert "error" not in line, line
    for k in BENCH_KEYS + CARD_KEYS:
        assert k in line, k
    assert line["value"] > 0 and line["genome_mbp"] == MBP
    assert line["n_reads"] == 8 and len(line["pass_s"]) == 1
    assert line["device"] == "cpu" and line["peak_device_bytes"] is None
    # the plain versions run on the CPU and count no launch
    assert line["kernel_launches"] == {
        "score_fill": 0, "corridor_windows": 0, "convex_fill": 0,
        "convex_backtrack": 0, "expand_votes": 0}
    counts = line["stage_counts"]
    assert counts["engine_waves"] > 0
    assert 0 < line["gcups_convex_dp"] <= line["gcups_convex_dp_padded"]

    from ngmlr_tpu.config import Config
    from ngmlr_tpu.pipeline.runner import Pipeline
    ref_fa = os.path.join(tmp_path, WORKDIR, "ref.fa")
    jp = Pipeline(Config(), ref_fa, use_cache=True)
    before = dict(jp.ctx.stats)
    jp.run(os.path.join(tmp_path, WORKDIR, "reads.fa"), io.BytesIO())
    for k in ("score_problems", "align_problems"):
        assert counts[k] == jp.ctx.stats[k] - before.get(k, 0), k
    assert jp.stats["reads"] == 8
    assert round(line["mapped_frac"] * 8) == jp.stats["mapped"]


def test_python_assembly_path_is_reported_as_an_error(tmp_path):
    """A Pipeline without the native engine (here NGMLR_TPU_NATIVE=0; on a
    machine where it fails to build, the same silent fallback) maps ~8x
    slower on the card: its line carries an error, and the exit code is 1."""
    proc = _run([BENCH], _env(tmp_path, NGMLR_TORCH_DEVICE="cpu",
                              BENCH_PASSES="1", NGMLR_TPU_NATIVE="0"))
    line = _one_line(proc)
    assert proc.returncode == 1
    assert "native assembly engine ran no wave" in line["error"]
    assert line["value"] > 0 and not line["stage_counts"].get("engine_waves")


def test_launch_errors_name_the_kernels_off_the_engines_record():
    """The bench holds a pass's launches to its engine's record with
    chip_smoke.check_launches: none under --nosse's plain kernels but
    expand_votes, and otherwise one per wave."""
    spec = importlib.util.spec_from_file_location("torch_bench", BENCH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    launch_error = module.launch_error
    record = {"score_launches": 9, "score_waves": 9, "align_launches": 40,
              "align_waves": 40, "search_v2_launches": 3, "plain_kernels": 0}
    launches = {"score_fill": 9, "corridor_windows": 40, "convex_fill": 40,
                "convex_backtrack": 40, "expand_votes": 3}
    assert launch_error(launches, record) is None
    bad = launch_error(dict(launches, convex_fill=39, expand_votes=0), record)
    assert "'convex_fill': 39" in bad and "'expand_votes': 0" in bad
    plain = dict.fromkeys(launches, 0)
    assert launch_error(dict(plain, expand_votes=3),
                        dict(record, plain_kernels=1)) is None
    assert launch_error(launches, dict(record, plain_kernels=1)) is not None


def test_no_card_and_no_cpu_request_prints_an_error_line(tmp_path):
    """No silent CPU path: without a card (none visible) and without
    NGMLR_TORCH_DEVICE=cpu the bench maps nothing and exits 1."""
    proc = _run([BENCH], _env(tmp_path, CUDA_VISIBLE_DEVICES=""))
    line = _one_line(proc)
    assert proc.returncode == 1
    assert "no CUDA card" in line["error"] and line["value"] == 0.0
    assert not os.path.exists(os.path.join(tmp_path, WORKDIR))


def test_deadline_still_prints_one_error_line(tmp_path):
    """The watchdog (at least 5 s) cuts a scale that cannot finish: one
    line, with an error, exit code 2."""
    proc = _run([BENCH], _env(tmp_path, NGMLR_TORCH_DEVICE="cpu",
                              BENCH_DEADLINE_S="1", BENCH_PASSES="1000"))
    line = _one_line(proc)
    assert proc.returncode == 2
    assert line["error"] == "no scale completed before deadline"
    assert line["value"] == 0.0


def test_a_crash_is_reported_as_a_crash(tmp_path):
    """A run that raises (a 0 Mbp genome has no room for a read) prints its
    one line with the cause, not the deadline's message, and exits 1."""
    proc = _run([BENCH], _env(tmp_path, NGMLR_TORCH_DEVICE="cpu",
                              BENCH_GENOME_MBP="0"))
    line = _one_line(proc)
    assert proc.returncode == 1
    assert line["error"].startswith("crashed: ValueError"), line["error"]
    assert line["value"] == 0.0


def test_prep_leaves_torch_caches_only(tmp_path):
    assert not _cache_ready(tmp_path)
    proc = _run([PREP, str(MBP)], _env(tmp_path))
    assert proc.returncode == 0, proc.stderr.decode()
    work = os.path.join(tmp_path, WORKDIR)
    assert sorted(os.path.basename(p) for p in glob.glob(work + "/*.npz")) \
        == ["ref.fa-enc.torch.npz", "ref.fa-ht-13-2.torch.npz"]
    assert not glob.glob(str(tmp_path) + "/**/*.tpu.npz", recursive=True)
    assert _cache_ready(tmp_path)
    again = _run([PREP, str(MBP)], _env(tmp_path))
    assert again.returncode == 0 and b"cache ready" in again.stdout


def test_bench_loads_the_prep_caches_without_rebuilding(tmp_path):
    """The bench's Pipeline finds and loads the caches prep wrote: after a
    CPU pass the same *.npz files lie there, none rewritten."""
    assert _run([PREP, str(MBP)], _env(tmp_path)).returncode == 0
    work = os.path.join(tmp_path, WORKDIR)

    def caches():
        return {os.path.basename(p): (os.stat(p).st_mtime_ns,
                                      os.stat(p).st_size)
                for p in glob.glob(work + "/*.npz")}
    before = caches()
    proc = _run([BENCH], _env(tmp_path, NGMLR_TORCH_DEVICE="cpu",
                              BENCH_PASSES="1"))
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert "error" not in _one_line(proc)
    assert len(before) == 2 and caches() == before
