"""Scale-out on the port, on the CPU: the wave mesh (-t N; here shards that
share the CPU, as the reference's tests run 8 virtual CPU devices), the
multi-process runs through torch.distributed (gloo), --shard with
scripts/merge_sams.py, and the serial execution path. Each test is the
counterpart of a reference test, named beside it."""

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ngmlr_tpu.ops import device_engine as jde
from ngmlr_tpu_torch.cli import build_parser, config_from_args
from ngmlr_tpu_torch.ops import device_engine as tde
from ngmlr_tpu_torch.io.reads import read_batches
from ngmlr_tpu_torch.parallel.mesh import (init_distributed, local_device,
                                           make_mesh)
from ngmlr_tpu_torch.pipeline.runner import Pipeline

from test_torch_e2e import TEST2, TEST6, _golden, _records, _run
from test_torch_kernels import PARAMS, _align_rows, _buffers, _score_rows

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH4 = ["cpu"] * 4


def _env(**extra):
    env = dict(os.environ, NGMLR_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               **extra)
    for k in ("NGMLR_TPU_COORDINATOR", "NGMLR_TPU_NUM_PROCS",
              "NGMLR_TPU_PROC_ID", "NGMLR_TPU_DEVICES"):
        if k not in extra:
            env.pop(k, None)
    return env


def _cli(argv, out, **env):
    return subprocess.run([sys.executable, "-m", "ngmlr_tpu_torch"] + argv
                          + ["-o", str(out)], cwd=REPO, env=_env(**env),
                          capture_output=True, timeout=600)


def _merge(out, *shards):
    subprocess.run([sys.executable, "scripts/merge_sams.py", str(out)]
                   + [str(s) for s in shards], check=True, cwd=REPO,
                   timeout=120)


def _body(path):
    return _records(open(path, "rb").read())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the mesh (tests/test_sharding.py)
# ---------------------------------------------------------------------------

def test_make_mesh_expands_and_clamps(monkeypatch, capfd):
    """cuda expands to cuda:0 .. cuda:N-1 (cuda:i to cuda:i ..), clamped
    with the reference's warning to the visible cards; the CPU is one
    device. No card is touched."""
    assert make_mesh(4, "cpu") == [torch.device("cpu")]
    assert "4 devices requested, 1 available" in capfd.readouterr().err
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert make_mesh(2, "cuda") == [torch.device("cuda", 0),
                                    torch.device("cuda", 1)]
    assert make_mesh(2, "cuda:1") == [torch.device("cuda", 1),
                                      torch.device("cuda", 2)]
    assert capfd.readouterr().err == ""
    assert len(make_mesh(5, "cuda")) == 3
    assert "5 devices requested, 3 available" in capfd.readouterr().err
    assert make_mesh(None, "cuda") == [torch.device("cuda", 0)]


@pytest.mark.parametrize("n_problems,n_mesh,guarded", [
    pytest.param(1, 4, False, id="1"),
    pytest.param(37, 4, False, id="37"),
    pytest.param(10, 2, True, id="guarded-row")])
def test_mesh_wave_matches_one_device_and_the_reference_mesh(n_problems,
                                                             n_mesh, guarded):
    """A score wave and an align wave over a mesh equal one device's,
    problem for problem, and the problem counts equal those of
    ngmlr_tpu's mesh of as many devices. One problem runs on one shard; 37
    split into contiguous shards, each its own launch. In the guarded case
    the last of ten score rows is past the MAX_SEQ_LEN guard: the port does
    not launch it, the reference's shards count it, and so does the port's
    mesh_problems_psum."""
    rng, genome, readbuf = _buffers(31)
    spk = _score_rows(rng, n_problems - guarded, 306, 256)
    if guarded:
        spk = np.concatenate([spk, _score_rows(rng, 1, tde.MAX_SEQ_LEN, 256)])
    # corridors of one lane class and size bucket: one chunk per wave
    apk = _align_rows(rng, genome, readbuf, min(n_problems, 20), (150, 250),
                      (100, 200), (20, 60), (1, 2, 3), plant=(0, 5))
    params = tuple(float(p) for p in PARAMS)
    mesh = ["cpu"] * n_mesh
    got = {}
    for dev in ("cpu", mesh):
        ctx = tde.DeviceContext(genome, device=dev)
        rb = ctx.upload_reads(readbuf)
        assert len(rb.replicas) == 1          # the shards share the CPU
        scores = ctx.score_wave_np(spk)
        score_psum = ctx.stats.get("mesh_problems_psum")
        res = ctx.align_finalize_pk(ctx.align_dispatch_pk(apk, params))
        got[ctx.n_devices] = (scores, res, ctx.stats, score_psum)
    (s1, r1, st1, _), (sm, rm, stm, psum_m) = got[1], got[n_mesh]
    np.testing.assert_array_equal(s1, sm)
    for a, b in zip(r1[:6], rm[:6]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r1[6], rm[6]):
        np.testing.assert_array_equal(a, b)
    assert "mesh_problems_psum" not in st1
    assert st1["score_launches"] == st1["score_waves"] == 1
    assert st1["align_launches"] == st1["align_waves"] == 1
    # 37 score rows: 3 shards of 16 rows; 20 align rows: 3 shards of 8;
    # 9 launched score rows and 10 align rows over 2: 2 shards of 8
    n_shards = {1: 1, 37: 3, 10: 2}[n_problems]
    assert stm["score_launches"] == stm["align_launches"] == n_shards
    assert psum_m == len(spk)
    assert stm["mesh_problems_psum"] == len(spk) + len(apk)

    jctx = jde.DeviceContext(genome, n_devices=n_mesh)
    jctx.upload_reads(readbuf)
    np.testing.assert_array_equal(jctx.score_wave_np(spk), sm)
    assert jctx.stats["mesh_problems_psum"] == psum_m
    if guarded:
        assert sm[-1] == -1.0 and (sm[:-1] >= 0).all()
    want = jctx.align_finalize_pk(jctx.align_dispatch_pk(apk, params))
    for a, b in zip(want[:6], rm[:6]):
        np.testing.assert_array_equal(a, b)
    assert jctx.stats["mesh_problems_psum"] == stm["mesh_problems_psum"]


def test_mesh_needs_a_replica_on_every_device():
    """A wave binds a ReadBuffer with a replica on every device of the
    mesh, and refuses one that lacks a device."""
    _, genome, readbuf = _buffers(1)
    ctx = tde.DeviceContext(genome, device=MESH4)
    spk = _score_rows(np.random.default_rng(0), 4, 306, 256)
    want = ctx.score_wave_np(spk, readbuf=ctx.upload_reads(readbuf))
    np.testing.assert_array_equal(ctx.score_wave_np(spk), want)
    with pytest.raises(ValueError, match="no replica on cpu"):
        ctx.score_wave_np(spk, readbuf=tde.ReadBuffer(
            {torch.device("meta"): torch.empty(8, device="meta")}))


@pytest.fixture(scope="module")
def one_device_test2():
    """test_2 on one device with the host search (the golden bytes)."""
    _, out = _run(TEST2, device="cpu")
    assert out == _golden("test_2.sam")
    return out


def test_full_pipeline_on_mesh_matches_single_device(one_device_test2):
    """tests/test_sharding.py:64: -t 4 (here 4 shards on the CPU) gives
    the bytes of one device, and the problem counters ride the mesh."""
    p, out = _run(TEST2, device=MESH4)
    assert p.ctx.mesh is not None and p.ctx.n_devices == 4
    assert out == one_device_test2
    st = p.ctx.stats
    assert st["mesh_problems_psum"] > 0
    assert st["score_launches"] > st["score_waves"]


def test_device_search_pipeline_on_mesh_matches_host_search(
        monkeypatch, one_device_test2):
    """tests/test_sharding.py:95: the device search (forced on) with every
    wave on the 4-shard mesh equals the host search on one device."""
    monkeypatch.setenv("NGMLR_TPU_DEVICE_SEARCH", "1")
    p, out = _run(TEST2, device=MESH4)
    assert p.dev_search is not None and p.dev_search.device == p.ctx.device
    assert p.ctx.stats["search_v2_launches"] > 0
    assert out == one_device_test2


def test_threads_past_the_visible_devices_warn_and_map(tmp_path):
    """-t 4 with NGMLR_TORCH_DEVICE=cpu warns as the reference does and
    maps on the one device."""
    r = _cli(TEST6 + ["-t", "4"], tmp_path / "t4.sam")
    assert r.returncode == 0, r.stderr[-2000:]
    assert b"4 devices requested, 1 available" in r.stderr
    assert _body(tmp_path / "t4.sam") == _golden("test_6.sam")


# ---------------------------------------------------------------------------
# --shard and the serial path (tests/test_e2e.py)
# ---------------------------------------------------------------------------

def test_shard_merge_matches_full_run(tmp_path):
    """tests/test_e2e.py:69: --shard 0/2 and 1/2, merged by
    scripts/merge_sams.py, reproduce the full run."""
    for extra, name in (([], "full"), (["--shard", "0/2"], "s0"),
                        (["--shard", "1/2"], "s1")):
        r = _cli(TEST6 + extra, tmp_path / (name + ".sam"))
        assert r.returncode == 0, r.stderr[-2000:]
    _merge(tmp_path / "merged.sam", tmp_path / "s0.sam", tmp_path / "s1.sam")
    assert _body(tmp_path / "full.sam") == _body(tmp_path / "merged.sam")
    assert _body(tmp_path / "full.sam") == _golden("test_6.sam")


def test_serial_mode_matches_pipelined_across_batches(monkeypatch):
    """tests/test_e2e.py:150: the serial path (NGMLR_TPU_SYNC) binds each
    batch's own read buffer; with 4-read batches the prep thread uploads
    batch N+1 while batch N maps."""
    monkeypatch.setenv("NGMLR_TPU_STRICT", "1")
    args = build_parser().parse_args(TEST2)

    def run(sync):
        if sync:
            monkeypatch.setenv("NGMLR_TPU_SYNC", "1")
        else:
            monkeypatch.delenv("NGMLR_TPU_SYNC", raising=False)
        cfg = config_from_args(args, TEST2)
        cfg.batch_reads = 4          # 12 reads -> 3 batches, prep overlaps
        p = Pipeline(cfg, args.reference, use_cache=True, device="cpu")
        buf = io.BytesIO()
        p.run(args.query, buf)
        return _records(buf.getvalue())

    serial = run(sync=True)
    assert serial == run(sync=False)
    assert serial == _golden("test_2.sam")


def test_cli_invalid_shard_is_friendly():
    """tests/test_e2e.py:176: a malformed --shard exits 1 with a
    message, not a traceback."""
    for bad in ["1", "0/two", "1/2/3", "/", "2/2"]:
        r = subprocess.run(
            [sys.executable, "-m", "ngmlr_tpu_torch", "-r", "x.fa",
             "-q", "y.fa", "--shard", bad],
            cwd=REPO, capture_output=True, env=_env(), timeout=120)
        assert r.returncode == 1, (bad, r.returncode, r.stderr[-2000:])
        assert b"Invalid --shard" in r.stderr, (bad, r.stderr)


# ---------------------------------------------------------------------------
# multi-process runs (tests/test_distributed.py)
# ---------------------------------------------------------------------------

def test_init_distributed_noop_without_coordinator(monkeypatch):
    """tests/test_distributed.py:14."""
    for k in ("NGMLR_TPU_COORDINATOR", "NGMLR_TPU_NUM_PROCS", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == (0, 1)


def test_init_distributed_single_process_coordinator():
    """tests/test_distributed.py:24: a real one-process gloo group."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import torch
import torch.distributed as dist
from ngmlr_tpu_torch.parallel.mesh import init_distributed, \\
    shutdown_distributed
assert init_distributed("127.0.0.1:{_free_port()}", num_processes=1,
                        process_id=0) == (0, 1)
assert dist.is_initialized() and dist.get_backend() == "gloo"
t = torch.ones(8)
dist.all_reduce(t)
assert float(t.sum()) == 8.0
shutdown_distributed()
assert not dist.is_initialized()
print("DIST_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=_env())
    assert r.returncode == 0, r.stderr[-2000:]
    assert "DIST_OK" in r.stdout


def test_init_distributed_refuses_processes_without_a_coordinator(
        monkeypatch):
    """More than one process (NGMLR_TPU_NUM_PROCS or torchrun's
    WORLD_SIZE) with no coordinator fails instead of each process mapping
    every read."""
    for k in ("NGMLR_TPU_COORDINATOR", "NGMLR_TPU_NUM_PROCS", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_distributed() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="2 processes but no coordinator"):
        init_distributed()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("NGMLR_TPU_NUM_PROCS", "3")
    with pytest.raises(RuntimeError, match="3 processes but no coordinator"):
        init_distributed()


def test_init_distributed_under_torchrun(tmp_path):
    """torchrun's MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK form the
    process group without NGMLR_TPU_COORDINATOR."""
    script = tmp_path / "probe.py"
    script.write_text(f"""
import sys
sys.path.insert(0, {REPO!r})
from ngmlr_tpu_torch.parallel.mesh import init_distributed, \\
    shutdown_distributed
rank, n = init_distributed()
open({str(tmp_path)!r} + "/rank%d.txt" % rank, "w").write("%d %d" % (rank, n))
shutdown_distributed()
""")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         "--master_addr=127.0.0.1", f"--master_port={_free_port()}",
         str(script)], capture_output=True, text=True, timeout=300,
        env=_env())
    assert r.returncode == 0, r.stderr[-2000:]
    assert [(tmp_path / f"rank{i}.txt").read_text() for i in range(2)] \
        == ["0 2", "1 2"]


def test_local_rank_takes_its_own_cards(monkeypatch):
    """Under torchrun each process of a node starts its mesh at
    cuda:LOCAL_RANK*width; a card past the visible ones raises. No card
    is touched."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert local_device("cuda", 2) == "cuda"
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert local_device("cuda", 2) == "cuda"
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert local_device("cuda", 2) == "cuda:2"
    assert local_device("cuda", 1) == "cuda:1"
    assert local_device("cpu", 2) == "cpu"
    assert local_device("cuda:3", 1) == "cuda:3"
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="starts at cuda:4"):
        local_device("cuda", 2)


def test_init_distributed_refuses_an_incomplete_setup(monkeypatch):
    """A coordinator without a process count or id, or one that never
    answers, fails the run: there is no quiet single-process run."""
    monkeypatch.setenv("NGMLR_TPU_COORDINATOR", "127.0.0.1:1")
    for k in ("NGMLR_TPU_NUM_PROCS", "NGMLR_TPU_PROC_ID", "WORLD_SIZE",
              "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="NGMLR_TPU_NUM_PROCS"):
        init_distributed()
    with pytest.raises(ValueError, match="process id 2"):
        init_distributed(num_processes=2, process_id=2)
    # process 1 of 2 against a port where no process 0 serves
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from ngmlr_tpu_torch.parallel import mesh
mesh.RENDEZVOUS_TIMEOUT_S = 2
mesh.init_distributed("127.0.0.1:{_free_port()}", 2, 1)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=_env())
    assert r.returncode != 0
    assert "timed out" in r.stderr


def test_two_process_distributed_run(tmp_path):
    """tests/test_distributed.py:50: two CLI processes under one
    coordinator (gloo), each mapping its round-robin shard of test_2 by
    NGMLR_TPU_PROC_ID (no --shard), merged, equal the single run."""
    port = _free_port()
    procs = []
    for pid in range(2):
        out = tmp_path / f"shard{pid}.sam"
        env = _env(NGMLR_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   NGMLR_TPU_NUM_PROCS="2", NGMLR_TPU_PROC_ID=str(pid))
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "ngmlr_tpu_torch"] + TEST2
            + ["-o", str(out)], cwd=REPO, env=env,
            stderr=subprocess.PIPE), out))
    errs = []
    try:
        for p, _ in procs:
            errs.append(p.communicate(timeout=600)[1])
    finally:
        for p, _ in procs:
            p.kill()
    assert all(p.returncode == 0 for p, _ in procs), \
        [e[-2000:] for e in errs]
    assert all(_body(out) for _, out in procs)
    _merge(tmp_path / "merged.sam", procs[0][1], procs[1][1])
    r = _cli(TEST2, tmp_path / "single.sam")
    assert r.returncode == 0, r.stderr[-2000:]
    assert _body(tmp_path / "single.sam") == _body(tmp_path / "merged.sam")


def test_env_driven_shard_assignment():
    """tests/test_distributed.py:113: the process shards of the input
    (read i goes to process i % n, as the CLI's shard/n_shards select)
    cover every read once, each in intake order."""
    path = TEST2[TEST2.index("-q") + 1]
    names = [r.name for b in read_batches(path, 5) for r in b]
    assert len(names) > 4
    for n in (2, 3, len(names) + 1):
        parts = [[r.name for b in read_batches(path, 5, shard=i, n_shards=n)
                  for r in b] for i in range(n)]
        assert [names[i::n] for i in range(n)] == parts
