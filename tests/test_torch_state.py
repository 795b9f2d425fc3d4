"""The port's mapping state and its boundaries: state.from_numpy rebuilds
the genome and k-mer index that ngmlr_tpu holds (and the port builds
itself, bit-exact against the reference binary's own index artifacts); the
port imports neither jax nor ngmlr_tpu; and it never falls back to the CPU
when no card is there.
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from ngmlr_tpu.index.kmer_index import KmerIndex as JKmerIndex
from ngmlr_tpu.io.reference import ReferenceGenome as JReferenceGenome
from ngmlr_tpu_torch import state
from ngmlr_tpu_torch.index.kmer_index import KmerIndex
from ngmlr_tpu_torch.io.reference import SPACER, ReferenceGenome
from ngmlr_tpu_torch.ops import device_engine as tde
from ngmlr_tpu_torch.pipeline import runner

from conftest import DATA_DIR, GOLDEN_DIR
from test_index_artifact import parse_ngm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FA = os.path.join(DATA_DIR, "test_2", "ref_chr21_20kb.fa")
PARAMS = (2.0, -5.0, -5.0, -5.0, -1.0, 0.15)


@pytest.mark.parametrize("k", [10, 13])
def test_from_numpy_matches_both_builds(k):
    jref = JReferenceGenome.from_fasta(REF_FA, use_cache=False)
    jidx = JKmerIndex.build(jref, k=k)
    st = state.from_numpy(jref.codes, jref.ref_start_pos, jref.names,
                          jref.ref_len, jidx.bucket_start, jidx.positions,
                          PARAMS, k=k, uniq_prefix=jidx.uniq_prefix,
                          device="cpu")
    ref = ReferenceGenome.from_fasta(REF_FA, use_cache=False)
    idx = KmerIndex.build(ref, k=k)
    for a, b in ((st.ref.codes, ref.codes),
                 (st.ref.ref_start_pos, ref.ref_start_pos),
                 (st.ref.ref_len, ref.ref_len),
                 (st.index.bucket_start, idx.bucket_start),
                 (st.index.positions, idx.positions)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert st.ref.names == ref.names
    assert (st.index.uniq_prefix is None) == (idx.uniq_prefix is None)
    if idx.uniq_prefix is not None:
        np.testing.assert_array_equal(st.index.uniq_prefix, idx.uniq_prefix)
    assert (st.index.k, st.index.kmer_skip, st.index.bin_size) == (
        idx.k, idx.kmer_skip, idx.bin_size)
    assert st.params.dtype == torch.float32
    np.testing.assert_array_equal(st.params.numpy(),
                                  np.asarray(PARAMS, np.float32))


@pytest.mark.parametrize("k", [10, 13])
def test_port_index_bit_exact_vs_reference_artifact(k):
    """As tests/test_index_artifact.py, for the port's own build."""
    art = os.path.join(GOLDEN_DIR, "index",
                       "ref_chr21_20kb.fa-ht-%d-2.2.ngm.xz" % k)
    file_k, idx_file, ref_table = parse_ngm(art)
    assert file_k == k
    n_prefix = 4 ** k
    tab0 = idx_file["tab"].astype(np.int64) - 1
    ours = KmerIndex.build(ReferenceGenome.from_fasta(REF_FA,
                                                      use_cache=False), k=k)
    counts = np.zeros(n_prefix, dtype=np.int64)
    if ours.uniq_prefix is None:
        counts[:] = np.diff(ours.bucket_start)
    else:
        counts[ours.uniq_prefix] = np.diff(ours.bucket_start)
    dense_start = np.zeros(n_prefix + 1, dtype=np.int64)
    dense_start[1:] = np.cumsum(counts)
    np.testing.assert_array_equal(dense_start, tab0)
    np.testing.assert_array_equal(ours.positions.astype(np.uint32), ref_table)


def _port_sources():
    root = os.path.join(REPO, "ngmlr_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield from sorted(glob.glob(os.path.join(REPO, "scripts", "torch_*.py")))


def test_port_imports_neither_jax_nor_the_reference():
    """Nor bench.py, whose run_scale imports ngmlr_tpu: the port's scripts
    carry their own copies of what they need from it."""
    bad = []
    n = 0
    scanned = set()
    for path in _port_sources():
        n += 1
        scanned.add(os.path.relpath(path, REPO))
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "ngmlr_tpu",
                                          "bench"):
                    bad.append("%s:%d %s" % (os.path.relpath(path, REPO),
                                             node.lineno, name))
    assert n > 30
    assert {"scripts/torch_bench.py", "scripts/torch_bench_prep.py",
            "scripts/torch_fuzz_vs_jax.py", "scripts/torch_human_scale.py",
            "scripts/torch_options_vs_jax.py", "scripts/torch_scale_vs_jax.py",
            "scripts/torch_tune_fill.py"} \
        <= scanned
    assert not bad, bad


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codes = np.zeros(64, np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tde.DeviceContext(codes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tde.DeviceContext(codes, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state.from_numpy(codes, np.asarray([0, 54 + SPACER]), [b"c"],
                         np.asarray([54]), np.zeros(2, np.int64),
                         np.zeros(0, np.uint32), PARAMS)
    ctx = tde.DeviceContext(codes, device="cpu")
    assert ctx.genome.device.type == "cpu"


def test_unported_options_raise():
    """A genome of more than 8 units raises instead of running something
    else: unit 8 would reach the sign bit of the W column."""
    codes = np.zeros(64, np.uint8)
    with pytest.raises(ValueError, match="at most 8 units"):
        tde.DeviceContext(codes, unit_spec=(9, 31, 64), device="cpu")
    assert runner._wave_depth(torch.device("cpu")) == 1
    assert runner._wave_depth(torch.device("cuda")) == 2
