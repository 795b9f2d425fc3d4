"""Genomes of more than one slab on the port (the TableUnit analog): the
unit planes of DeviceContext, score_fill and convex_fill reading each row's
plane, the waves over unit rows, the unit-local descriptors and the
unit-major host search, each against ngmlr_tpu on the same inputs (numpy
seeds), and the multi-unit pipeline of tests/test_table_units.py against
the flat run and the reference's. Slabs are shrunk by
NGMLR_TPU_UNIT_SLAB_BITS, as the reference's own tests shrink them."""

import io

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ngmlr_tpu.ops import device_engine as jde
from ngmlr_tpu_torch.ops import device_engine as tde
from ngmlr_tpu_torch.ops import kernels as K

from chip_smoke import table_unit_files, unit_rows
from test_table_units import _make_reads, _write_fasta
from test_torch_kernels import PARAMS, _convex_both

torch.set_num_threads(1)

R = 1 << 16
P_PARAMS = tuple(float(p) for p in PARAMS)


def _unit_genome(seed, U, bits, tail):
    """Codes of U - 1 whole slabs of 2^bits and a tail, and the unit_spec
    (U, bits, plane_len) of a slab plus a quarter-slab halo."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, ((U - 1) << bits) + tail).astype(np.uint8)
    slab = 1 << bits
    return rng, codes, (U, bits, min(slab + slab // 4, len(codes)))


def _contexts(codes, unit_spec, readbuf, device="cpu"):
    jctx = jde.DeviceContext(codes, unit_spec=unit_spec)
    jctx.upload_reads(readbuf)
    tctx = tde.DeviceContext(codes, unit_spec=unit_spec, device=device)
    tctx.upload_reads(readbuf)
    return jctx, tctx


# ---------------------------------------------------------------------------
# the planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("U", [2, 3, 4])
def test_planes_match_the_reference(U):
    """[U, planeP] planes, N-padded, plane u the plane_len codes from
    u << bits, byte for byte as ngmlr_tpu's DeviceContext builds them (its
    unit_spec from a shrunk-slab ReferenceGenome's geometry)."""
    bits = 20
    slab = 1 << bits
    halo = min(1 << 24, max(1 << 20, slab >> 3))
    rng = np.random.default_rng(U)
    codes = rng.integers(0, 5, (U - 1) * slab + 300_000).astype(np.uint8)
    spec = (U, bits, min(slab + halo, len(codes)))
    want = np.asarray(jde.DeviceContext(codes, unit_spec=spec).genome)
    ctx = tde.DeviceContext(codes, unit_spec=spec, device="cpu")
    assert ctx.n_units == U and ctx.genome.shape == want.shape
    np.testing.assert_array_equal(ctx.genome.numpy(), want)


def test_more_than_eight_units_raise():
    """Eight units build; a ninth would set the W column's sign bit."""
    _, codes, spec = _unit_genome(8, 8, 14, 5000)
    ctx = tde.DeviceContext(codes, unit_spec=spec, device="cpu")
    assert ctx.genome.shape == (8, 1 << 20)
    _, codes, spec = _unit_genome(9, 9, 14, 5000)
    with pytest.raises(ValueError, match="at most 8 units"):
        tde.DeviceContext(codes, unit_spec=spec, device="cpu")


def test_a_row_of_a_missing_unit_raises():
    """A wave's rows must name units of the genome: any unit on a flat
    genome, unit 3 on a 3-unit genome, raise before anything launches."""
    rng, codes, spec = _unit_genome(3, 3, 15, 9000)
    readbuf = rng.integers(0, 5, R).astype(np.uint8)
    ctx = tde.DeviceContext(codes, unit_spec=spec, device="cpu")
    flat = tde.DeviceContext(codes, device="cpu")
    planes = np.zeros((4, ctx.genome.shape[1]), np.uint8)
    apk = unit_rows(rng, planes, readbuf.copy(), 8, (200, 300), (24, 60),
                    (1, 2))
    K.reset_launches()
    for c, pk in ((flat, apk[1:2]), (ctx, apk[3:4])):
        c.upload_reads(readbuf)
        with pytest.raises(ValueError, match="names genome unit"):
            c.score_wave_np(np.ascontiguousarray(pk[:, :7]))
        with pytest.raises(ValueError, match="names genome unit"):
            c.align_dispatch_pk(pk, P_PARAMS)
    assert sum(K.launches.values()) == 0


# ---------------------------------------------------------------------------
# the kernels' plain versions on unit rows against the JAX scan twins
# ---------------------------------------------------------------------------

def _planes(seed, U=4, planeP=1 << 16):
    rng = np.random.default_rng(seed)
    return (rng, rng.integers(0, 5, (U, planeP)).astype(np.uint8),
            rng.integers(0, 5, R).astype(np.uint8))


def test_score_fill_on_unit_rows_matches_jax_scan():
    """Score rows over four planes (windows ending at, running past and
    lying in the halo of their plane's end) through score_fill on the CPU
    and _score_kernel(impl="scan") on the same 2-D genome."""
    rng, planes, readbuf = _planes(41)
    pk = np.ascontiguousarray(unit_rows(rng, planes, readbuf, 48, (306, 307),
                                        (1, 2), (1,), H_max=256)[:, :7])
    assert set((pk[:, 3] >> 28).tolist()) == {0, 1, 2, 3}
    want = np.asarray(jde._score_kernel(
        jnp.asarray(planes), jnp.asarray(readbuf), jnp.asarray(pk),
        Rp=320, Qp=256, impl="scan"))
    got = K.score_fill(torch.from_numpy(planes), torch.from_numpy(readbuf),
                       torch.from_numpy(pk), 320, 256).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.median(got) >= 15           # the queries are their windows'


def test_convex_on_unit_rows_matches_jax_scan():
    """Align rows of every kind and corridor mode over four planes through
    the port's fused chain and _convex_kernel(impl="scan")."""
    rng, planes, readbuf = _planes(43)
    pk = unit_rows(rng, planes, readbuf, 12, (200, 480), (24, 120),
                   (0, 1, 2, 3), H_max=511)
    (tp, ts), (jp, js) = _convex_both(planes, readbuf, pk, 512, 512, 128)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)
    assert ts[:, 5].sum() >= 4


def test_gather_ref_clamps_inside_the_plane():
    """A window past its plane reads the plane's last byte, never the next
    plane: as the reference's _gather_ref, not a flat index."""
    planes = np.arange(3 * 64, dtype=np.uint8).reshape(3, 64) % 5
    planes[:, -1] = (1, 2, 3)
    t = torch.from_numpy(planes)
    n = 3
    ds = torch.tensor([60, 60, 60])
    got = K.gather_ref(t, ds, torch.zeros(n, dtype=torch.long),
                       ds + 10, torch.full((n,), 10), 10,
                       torch.tensor([0, 1, 2]))
    np.testing.assert_array_equal(got[:, 4:].numpy(),
                                  np.repeat([[1], [2], [3]], 6, axis=1))
    np.testing.assert_array_equal(got[:, :4].numpy(), planes[:, 60:64])


# ---------------------------------------------------------------------------
# the waves against the reference's context
# ---------------------------------------------------------------------------

def _wave_inputs(seed):
    """A 3-unit genome's contexts' planes, and score and align rows over
    them with windows at each plane's data end (plane_len)."""
    rng, codes, spec = _unit_genome(seed, 3, 16, 30_000)
    planes = tde.DeviceContext(codes, unit_spec=spec,
                               device="cpu").genome.numpy()
    readbuf = rng.integers(0, 5, R).astype(np.uint8)
    spk = np.ascontiguousarray(unit_rows(
        rng, planes, readbuf, 30, (260, 300), (1, 2), (1,), H_max=256,
        plane_len=spec[2])[:, :7])
    apk = unit_rows(rng, planes, readbuf, 9, (200, 700), (24, 200),
                    (1, 2, 3), H_max=700, q0=30 * 256, plane_len=spec[2])
    return codes, spec, readbuf, spk, apk


def _assert_align_equal(got, want):
    for g, w in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[6], want[6]):
        np.testing.assert_array_equal(g, w)


def test_waves_on_units_match_the_reference_context():
    """score_wave_np and align_dispatch_pk / align_finalize_pk of a 3-unit
    context against ngmlr_tpu's DeviceContext with the same unit_spec."""
    codes, spec, readbuf, spk, apk = _wave_inputs(51)
    jctx, tctx = _contexts(codes, spec, readbuf)
    np.testing.assert_array_equal(tctx.score_wave_np(spk),
                                  jctx.score_wave_np(spk))
    _assert_align_equal(
        tctx.align_finalize_pk(tctx.align_dispatch_pk(apk, P_PARAMS)),
        jctx.align_finalize_pk(jctx.align_dispatch_pk(apk, P_PARAMS)))
    assert tctx.stats["alignment_ok"] == jctx.stats["alignment_ok"] > 0
    assert tctx.stats["align_waves"] == jctx.stats["align_waves"]


def test_unit_waves_on_a_two_shard_mesh_match_one_device():
    """The same waves on device=["cpu", "cpu"]: the planes on every shard,
    each shard's rows reading their own planes, the results equal one
    device's and the reference's problem counts."""
    codes, spec, readbuf, spk, apk = _wave_inputs(53)
    one = tde.DeviceContext(codes, unit_spec=spec, device="cpu")
    mesh = tde.DeviceContext(codes, unit_spec=spec, device=["cpu", "cpu"])
    assert mesh.n_devices == 2 and mesh.genome.dim() == 2
    out = []
    for c in (one, mesh):
        c.upload_reads(readbuf)
        out.append((c.score_wave_np(spk),
                    c.align_finalize_pk(c.align_dispatch_pk(apk, P_PARAMS))))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    _assert_align_equal(out[1][1], out[0][1])
    assert mesh.stats["score_launches"] > mesh.stats["score_waves"]
    assert mesh.stats["mesh_problems_psum"] == len(spk) + len(apk)


# ---------------------------------------------------------------------------
# the host side (tests/test_table_units.py:84, :140)
# ---------------------------------------------------------------------------

def test_unitized_descs_reencode_flat(tmp_path, monkeypatch):
    """decode_*_desc with units is the flat descriptor re-based by the unit
    slab, and equal to ngmlr_tpu's unitized descriptor."""
    from ngmlr_tpu.io.reference import ReferenceGenome as JRef
    from ngmlr_tpu_torch.io.reference import ReferenceGenome
    rng = np.random.default_rng(5)
    ref_path = str(tmp_path / "u.fa")
    _write_fasta(ref_path, rng, 3_000_000, 2)
    monkeypatch.delenv("NGMLR_TPU_UNIT_SLAB_BITS", raising=False)
    flat = ReferenceGenome.from_fasta(ref_path, use_cache=False)
    monkeypatch.setenv("NGMLR_TPU_UNIT_SLAB_BITS", "21")
    uni = ReferenceGenome.from_fasta(ref_path, use_cache=False)
    juni = JRef.from_fasta(ref_path, use_cache=False)
    assert uni.n_units == juni.n_units == 3
    assert (uni.unit_bits, uni.unit_halo, uni.unit_plane_len) == (
        juni.unit_bits, juni.unit_halo, juni.unit_plane_len)
    n = 0
    for _ in range(300):
        pos = int(rng.integers(0, flat.concat_len))
        blen = int(rng.integers(10, 50_000))
        for fn in ("decode_window_desc", "decode_exact_desc"):
            a = getattr(flat, fn)(pos, blen)
            b = getattr(uni, fn)(pos, blen)
            j = getattr(juni, fn)(pos, blen)
            assert (b is None) == (a is None) == (j is None)
            if b is None:
                continue
            assert (b.ds, b.hi, b.diff, b.W, b.unit) == (j.ds, j.hi, j.diff,
                                                         j.W, j.unit)
            if fn == "decode_exact_desc" and a.hi == 0:
                assert b.hi == 0             # fully-in-spacer sentinel
                continue
            base = b.unit << uni.unit_bits
            assert (b.ds + base, b.hi + base, b.diff, b.W) == \
                (a.ds, a.hi, a.diff, a.W)
            n += b.unit > 0
    assert n > 50


def test_host_search_unit_major_order(tmp_path, monkeypatch):
    """search_batch with n_units: the flat run's candidate set, in the
    reference's unit-major order (equal to ngmlr_tpu's, element for
    element)."""
    from ngmlr_tpu.index.kmer_index import KmerIndex as JIndex
    from ngmlr_tpu.io.reference import ReferenceGenome as JRef
    from ngmlr_tpu.seed.candidates import search_batch as jsearch
    from ngmlr_tpu_torch.index.kmer_index import KmerIndex
    from ngmlr_tpu_torch.io.reference import ReferenceGenome
    from ngmlr_tpu_torch.seed.candidates import search_batch
    rng = np.random.default_rng(13)
    ref_path = str(tmp_path / "s.fa")
    chroms = _write_fasta(ref_path, rng, 2_000_000, 2)
    monkeypatch.delenv("NGMLR_TPU_UNIT_SLAB_BITS", raising=False)
    idx = KmerIndex.build(ReferenceGenome.from_fasta(ref_path,
                                                     use_cache=False))
    jidx = JIndex.build(JRef.from_fasta(ref_path, use_cache=False))
    seqs = []
    for _ in range(40):
        c = int(rng.integers(0, 2))
        n = int(rng.integers(100, 257))
        pos = int(rng.integers(0, len(chroms[c]) - n))
        seqs.append(chroms[c][pos:pos + n].tobytes())
    flat = search_batch(idx, seqs)
    multi = search_batch(idx, seqs, n_units=4, unit_bits=20)
    jmulti = jsearch(jidx, seqs, n_units=4, unit_bits=20)
    for i, (a, b, j) in enumerate(zip(flat, multi, jmulti)):
        for f in ("locations", "reverse", "counts"):
            np.testing.assert_array_equal(getattr(b, f), getattr(j, f))
        assert b.mq_zero == j.mq_zero
        ka = sorted(zip(a.locations.tolist(), a.reverse.tolist(),
                        a.counts.tolist()))
        kb = sorted(zip(b.locations.tolist(), b.reverse.tolist(),
                        b.counts.tolist()))
        assert ka == kb, "subread %d" % i
    assert sum(len(b.locations) for b in multi) >= 40


# ---------------------------------------------------------------------------
# the pipeline (tests/test_table_units.py:69)
# ---------------------------------------------------------------------------

def _port_map(ref_path, reads_path, monkeypatch, slab_bits):
    from ngmlr_tpu_torch.config import Config
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    if slab_bits:
        monkeypatch.setenv("NGMLR_TPU_UNIT_SLAB_BITS", str(slab_bits))
    else:
        monkeypatch.delenv("NGMLR_TPU_UNIT_SLAB_BITS", raising=False)
    monkeypatch.setenv("NGMLR_TPU_STRICT", "1")
    pipe = Pipeline(Config(), ref_path, use_cache=False, device="cpu")
    out = io.BytesIO()
    stats = pipe.run(reads_path, out)
    sam = b"\n".join(ln for ln in out.getvalue().split(b"\n")
                     if not ln.startswith(b"@PG"))
    return sam, stats, pipe


def test_multi_unit_pipeline_byte_identical(tmp_path, monkeypatch):
    """Two 5 Mbp chromosomes at 2^22-base slabs (3 units) and 14 reads: the
    port's multi-unit SAM (host search, Python assembly path) equals its
    flat SAM and ngmlr_tpu's multi-unit SAM. The files are chip_smoke's
    phase 7(a), the same bytes as tests/test_table_units.py writes."""
    from test_table_units import _map as jmap
    ref_path, reads_path = table_unit_files(str(tmp_path / "smoke"))
    rng = np.random.default_rng(31)
    chroms = _write_fasta(str(tmp_path / "multi.fa"), rng, 5_000_000, 2)
    _make_reads(str(tmp_path / "reads.fa"), rng, chroms, 14)
    for a, b in ((ref_path, "multi.fa"), (reads_path, "reads.fa")):
        assert open(a, "rb").read() == (tmp_path / b).read_bytes()

    sam_flat, st_flat, _ = _port_map(ref_path, reads_path, monkeypatch, None)
    sam_units, st_units, pipe = _port_map(ref_path, reads_path, monkeypatch,
                                          22)
    assert pipe.ref.n_units == pipe.ctx.n_units == 3
    assert pipe.ctx.genome.dim() == 2
    assert pipe.native is None and pipe.dev_search is None
    assert st_units["mapped"] == st_flat["mapped"] == 14
    assert sam_units == sam_flat
    # the reference's Python path on its own unit planes
    sam_ref, _, jpipe = jmap(ref_path, reads_path, monkeypatch, 22)
    assert jpipe.ref.n_units == 3
    assert sam_units == sam_ref
