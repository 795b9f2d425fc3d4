"""The port's oracle modules on the CPU: ops/convex.py (the wavefront scan
and run_batch), ops/ungapped.py (the ungapped scorer) and ops/convex_ref.py
(the scalar fill). Each case of tests/test_convex.py and
tests/test_ungapped.py, with the port's modules; the batch-split cases of
tests/test_sharding.py:17-35; both scans against the JAX package's on the
same numpy-seeded inputs, bit for bit; and tests/test_ssw_crosscheck.py's
check against the vendored ssw library, which skips as the reference's
does where the reference tree is not there.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmlr_tpu.ops import convex as jconvex
from ngmlr_tpu.ops import ungapped as jungapped
from ngmlr_tpu_torch.align.aligner import (AlignerConfig, align_banded,
                                           compute_alignment, corridor_linear,
                                           materialize_offsets)
from ngmlr_tpu_torch.align.cigar import (backtrack, backtrack_and_convert,
                                         convert_cigar)
from ngmlr_tpu_torch.ops.convex import (DEFAULT_PARAMS, BandSpec,
                                        WavefrontResult, _wavefront_kernel,
                                        run_batch)
from ngmlr_tpu_torch.ops.convex_ref import fill_matrix
from ngmlr_tpu_torch.ops.types import WavefrontResult as TypesResult
from ngmlr_tpu_torch.ops.ungapped import (MAX_SEQ_LEN, nt_codes,
                                          score_batch, score_batch_kernel,
                                          score_pair_numpy)

from chip_smoke import (align_cases, align_diffs, fill_cases, fill_diffs,
                        mutate_seq, oracle_views, rand_seq, score_pairs)
from test_ssw_crosscheck import _mutate as _ssw_mutate
from test_ssw_crosscheck import ssw, ssw_score  # noqa: F401 (fixture)

torch.set_num_threads(1)


def _rand_seq(rng, n, alphabet=b"ACGT"):
    return bytes(rng.choice(list(alphabet), size=n))


# ---------------------------------------------------------------------------
# tests/test_convex.py
# ---------------------------------------------------------------------------

def test_wavefront_matches_oracle_random():
    for trial, case in enumerate(fill_cases()):
        _, diffs = fill_diffs(*case, device="cpu")
        assert diffs == [], trial


def test_device_engine_matches_host_oracle():
    """align_banded (the engine's fused windows, fill and backtrack) gives
    the Align of run_batch + the host backtrack + convert_cigar."""
    for trial, case in enumerate(align_cases()):
        assert align_diffs(*case, device="cpu") == [], trial


def test_wavefront_perfect_match():
    rng = np.random.default_rng(5)
    qry = rand_seq(rng, 50)
    ref = rand_seq(rng, 20) + qry + rand_seq(rng, 20)
    ref_win, qry_view = oracle_views(ref, qry, "cpu")
    a = align_banded(ref_win, qry_view, corridor_linear(64), 0, 0)
    assert a is not None
    assert a.cigar == "50M"
    assert a.score == 100.0
    assert a.nm == 0 and a.identity == 1.0
    assert a.position_offset == 20
    assert a.md == "50"


def test_align_with_mutations_cigar_length():
    rng = np.random.default_rng(9)
    truth = rand_seq(rng, 400)
    qry = mutate_seq(rng, truth)
    ref = rand_seq(rng, 50) + truth + rand_seq(rng, 50)
    ref_win, qry_view = oracle_views(ref, qry, "cpu")
    a = align_banded(ref_win, qry_view, corridor_linear(128), 0, 0)
    assert a is not None
    # sum of M/I/S ops == read length (ConvexAlignFast.cpp check)
    consumed = sum(int(n) for n, op in re.findall(r"(\d+)([MIS])", a.cigar))
    assert consumed == len(qry)
    assert a._final_cigar_length == len(qry)
    assert a.identity > 0.85


def test_convex_gap_prefers_long_gap_extension():
    rng = np.random.default_rng(21)
    left = rand_seq(rng, 80)
    right = rand_seq(rng, 80)
    gap = rand_seq(rng, 30)
    ref = left + gap + right
    qry = left + right
    ref_win, qry_view = oracle_views(ref, qry, "cpu")
    a = align_banded(ref_win, qry_view, corridor_linear(100), 0, 0)
    assert a is not None
    assert a.cigar == "80M30D80M"
    assert a.md == "80^" + gap.decode() + "80"
    assert a.nm == 30


def test_external_clips_added():
    rng = np.random.default_rng(30)
    qry = rand_seq(rng, 60)
    ref_win, qry_view = oracle_views(qry, qry, "cpu")
    a = align_banded(ref_win, qry_view, corridor_linear(32), 7, 3)
    assert a.cigar == "7S60M3S"
    assert a.qstart == 7 and a.qend == 3
    assert a._final_cigar_length == 70


def test_reverse_query_view():
    rng = np.random.default_rng(33)
    qry_fwd = rand_seq(rng, 64)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    qry_rc = qry_fwd.translate(comp)[::-1]
    ref = rand_seq(rng, 10) + qry_rc + rand_seq(rng, 10)
    ref_win, view = oracle_views(ref, qry_fwd, "cpu")
    a = align_banded(ref_win, view.revcomp(), corridor_linear(48), 0, 0)
    assert a is not None
    assert a.cigar == "64M"
    assert a.position_offset == 10


@pytest.mark.parametrize("corridor,cigar", [(16, "100M60S"),
                                            (128, "100M40D60M")],
                         ids=["narrow-clips", "wide-spans-deletion"])
def test_compute_alignment_corridor(corridor, cigar):
    """A 40-base deletion: a 16-wide linear corridor clips, as the
    reference does; a 128-wide one spans it."""
    rng = np.random.default_rng(40)
    truth = rand_seq(rng, 200)
    qry = truth[:100] + truth[140:]
    ref_win, qry_view = oracle_views(truth, qry, "cpu")
    a = compute_alignment(None, corridor, qry_view, 0, 0, len(qry), ref_win,
                          AlignerConfig(), short_read=True)
    assert a is not None
    assert a.cigar == cigar


def test_native_cigar_matches_python():
    from ngmlr_tpu_torch.native import get_lib
    if get_lib() is None:
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(77)
    for trial in range(10):
        truth = rand_seq(rng, 300)
        qry = mutate_seq(rng, truth)
        ref = rand_seq(rng, 40) + truth + rand_seq(rng, 40)
        c = corridor_linear(96)
        offs = materialize_offsets(c, len(qry))
        spec = BandSpec(ref, qry, np.asarray(offs), c.width).prepare()
        res = run_batch([spec], device="cpu")[0]
        py = backtrack(res, offs, c.width, len(qry))
        nat = backtrack_and_convert(res, offs, c.width, ref, qry, 3, 5)
        if py is None:
            assert nat is None
            continue
        ops, ref_position, _ = py
        a_py, len_py = convert_cigar(ops, ref, ref_position, qry, 3, 5)
        a_nat, len_nat = nat
        assert len_py == len_nat, trial
        for k in ("cigar", "md", "nm", "qstart", "qend", "cigar_op_count",
                  "first_ref_pos", "first_read_pos", "last_ref_pos",
                  "last_read_pos"):
            assert getattr(a_py, k) == getattr(a_nat, k), (trial, k)
        assert a_py.identity == pytest.approx(a_nat.identity)
        np.testing.assert_array_equal(a_py.nm_per_position,
                                      a_nat.nm_per_position)


def test_one_wavefront_result_class():
    """align/cigar.py's backtrack reads the class ops/convex.py returns."""
    assert WavefrontResult is TypesResult


# ---------------------------------------------------------------------------
# tests/test_ungapped.py
# ---------------------------------------------------------------------------

def test_simple_scores():
    assert score_pair_numpy(b"ACGTACGT", b"ACGT") == 4.0
    assert score_pair_numpy(b"AAAA", b"TTTT") == 0.0
    assert score_pair_numpy(b"ACGTTTGCA", b"ACGTATGCA") == 7.0  # 4 + (-1) + 4


def test_n_and_x_score_zero():
    assert score_pair_numpy(b"ACNNGT", b"ACNNGT") == 4.0
    assert score_pair_numpy(b"ACxxGT", b"ACGGGT") == 4.0  # x bridges at 0 cost


def test_batch_matches_numpy():
    rng = np.random.default_rng(3)
    refs, qrys = [], []
    for _ in range(32):
        refs.append(_rand_seq(rng, int(rng.integers(20, 306)), b"ACGTN"))
        qrys.append(_rand_seq(rng, int(rng.integers(10, 266)), b"ACGTN"))
    got = score_batch(refs, qrys, device="cpu")
    want = np.asarray([score_pair_numpy(r, q) for r, q in zip(refs, qrys)])
    np.testing.assert_array_equal(got, want)


def test_batch_embedded_match():
    rng = np.random.default_rng(4)
    q = _rand_seq(rng, 100)
    r = _rand_seq(rng, 80) + q + _rand_seq(rng, 80)
    assert score_batch([r], [q], device="cpu")[0] == 100.0


def test_max_seq_len_guard():
    """ssw's maxSeqLen guard: a pair past it scores -1 from both scorers,
    its neighbours as usual."""
    rng = np.random.default_rng(6)
    q = _rand_seq(rng, 200)
    refs = [_rand_seq(rng, MAX_SEQ_LEN), q + b"ACGT", b"ACGT" * 50]
    qrys = [q, q, _rand_seq(rng, MAX_SEQ_LEN - 1)]
    got = score_batch(refs, qrys, device="cpu")
    want = [score_pair_numpy(r, s) for r, s in zip(refs, qrys)]
    assert want == [-1.0, 200.0, -1.0]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_ungapped_limits_match_the_engine():
    from ngmlr_tpu_torch.ops import device_engine
    assert MAX_SEQ_LEN == device_engine.MAX_SEQ_LEN == jungapped.MAX_SEQ_LEN


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = BandSpec(b"ACGT", b"ACG", np.zeros(3, np.int64), 4)
    for call in (lambda: score_batch([b"ACGT"], [b"ACG"]),
                 lambda: run_batch([spec]),
                 lambda: score_batch([b"ACGT"], [b"ACG"], device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert score_batch([b"ACGT"], [b"ACG"], device="cpu")[0] == 3.0
    assert run_batch([spec], device="cpu")[0].score > 0


# ---------------------------------------------------------------------------
# tests/test_sharding.py:17-35, and the JAX package's scans
# ---------------------------------------------------------------------------

def _score_inputs():
    """tests/test_sharding.py:19-23."""
    rng = np.random.default_rng(0)
    B, R, Q = 16, 128, 96
    return (rng.integers(0, 5, size=(B, R)).astype(np.uint8),
            rng.integers(0, 5, size=(B, Q)).astype(np.uint8))


def _wavefront_inputs():
    """tests/test_sharding.py:39-44."""
    rng = np.random.default_rng(1)
    B, Tp = 8, 256
    ref = rng.integers(65, 85, size=(B, Tp)).astype(np.uint8)
    qry = rng.integers(65, 85, size=(B, Tp)).astype(np.uint8)
    ymin = np.zeros((B, Tp), dtype=np.int32)
    ymax = np.minimum(np.arange(Tp, dtype=np.int32), 60)[None, :].repeat(B, 0)
    return ref, qry, ymin, ymax


def _band_inputs():
    """Eight mutated pairs of 150-250 bases, prepared as BandSpecs over
    linear corridors of 24-80 and padded as run_batch pads them. Returns
    (the kernel's inputs, the specs)."""
    rng = np.random.default_rng(2)
    Tp, specs = 512, []
    for _ in range(8):
        truth = rand_seq(rng, int(rng.integers(150, 250)))
        qry = mutate_seq(rng, truth)
        c = corridor_linear(int(rng.integers(24, 80)))
        specs.append(BandSpec(truth, qry, materialize_offsets(c, len(qry)),
                              c.width).prepare())
    ref = np.zeros((8, Tp), np.uint8)
    qry = np.full((8, Tp), 255, np.uint8)
    ymin = np.zeros((8, Tp), np.int32)
    ymax = np.full((8, Tp), -1, np.int32)
    for b, sp in enumerate(specs):
        ref[b, :len(sp.ref)] = np.frombuffer(sp.ref, np.uint8)
        qry[b, :len(sp.qry)] = np.frombuffer(sp.qry, np.uint8)
        ymin[b, :sp.T], ymax[b, :sp.T] = sp.ymin, sp.ymax
    return (ref, qry, ymin, ymax), specs


def _wavefront(args, L=128):
    t = [torch.from_numpy(a) for a in args]
    out = _wavefront_kernel(*t, torch.tensor(DEFAULT_PARAMS,
                                             dtype=torch.float32), L=L)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("kernel", ["score_batch_kernel",
                                    "_wavefront_kernel"])
def test_batch_split_matches_whole_batch(kernel):
    """A batch's rows are independent: the whole seeded batch equals the
    same kernel run on row slices, concatenated (the JAX package's
    sharded-mesh checks, tests/test_sharding.py:17-35)."""
    if kernel == "score_batch_kernel":
        refs, qrys = _score_inputs()
        whole = score_batch_kernel(torch.from_numpy(refs),
                                   torch.from_numpy(qrys)).numpy()
        parts = np.concatenate([
            score_batch_kernel(torch.from_numpy(refs[s]),
                               torch.from_numpy(qrys[s])).numpy()
            for s in (slice(0, 3), slice(3, 8), slice(8, 16))])
        np.testing.assert_array_equal(whole, parts)
        return
    args = _wavefront_inputs()
    whole = _wavefront(args)
    parts = [_wavefront([a[s] for a in args])
             for s in (slice(0, 1), slice(1, 4), slice(4, 8))]
    # dirs are [Tp // 4, B, L]: rows on axis 1; best, y, x on axis 0
    for i, w in enumerate(whole):
        np.testing.assert_array_equal(
            w, np.concatenate([p[i] for p in parts], axis=1 if i == 0 else 0))


def _jax_wavefront(args):
    return [np.asarray(w) for w in jconvex._wavefront_kernel(
        *(jnp.asarray(a) for a in args),
        jnp.asarray(DEFAULT_PARAMS, dtype=jnp.float32), L=128)]


def test_wavefront_kernel_matches_jax():
    """tests/test_sharding.py's inputs: packed dirs, best, y and x equal."""
    args = _wavefront_inputs()
    got, want = _wavefront(args), _jax_wavefront(args)
    for name, g, w in zip(("dirs", "best", "best_y", "best_x"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[1].max() > 0


def test_wavefront_kernel_on_bands_matches_jax_and_the_scalar_oracle():
    """Mutated pairs over real corridors: the best score and cell equal
    the JAX package's, and every direction in each band equals
    fill_matrix's. The JAX scan's own directions differ at a few tie
    cells: XLA on the CPU fuses ge + run * gdecay into one multiply-add,
    rounded once, where the port and the scalar oracle round the product
    and the sum (ConvexAlignFast.cpp's order), so the port's directions
    are held against fill_matrix, cell by cell."""
    args, specs = _band_inputs()
    got, want = _wavefront(args), _jax_wavefront(args)
    for name, g, w in zip(("best", "best_y", "best_x"), got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    for b, sp in enumerate(specs):
        mine = WavefrontResult(0.0, 0, 0, got[0][:, b], 128)
        bs, _, _, dirs = fill_matrix(sp.ref, sp.qry, sp.offsets, sp.width)
        assert bs == pytest.approx(float(got[1][b]))
        for y in range(len(sp.qry)):
            o = int(sp.offsets[y])
            for x in range(max(0, o), min(len(sp.ref), o + sp.width)):
                assert mine.dir_at(x, y) == dirs[y, x], (b, x, y)
def test_score_batch_kernel_matches_jax():
    for refs, qrys in (_score_inputs(), _hot_shape_codes()):
        want = np.asarray(jungapped.score_batch_kernel(jnp.asarray(refs),
                                                       jnp.asarray(qrys)))
        got = score_batch_kernel(torch.from_numpy(refs),
                                 torch.from_numpy(qrys)).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _hot_shape_codes():
    """The scorer's hot shape (306-base windows, 256-base subreads)
    padded as score_batch pads it, from seeded related pairs."""
    pairs = score_pairs(np.random.default_rng(8), 16)
    rc = np.full((16, 512), 4, np.uint8)
    qc = np.full((16, 256), 4, np.uint8)
    for i, (r, q) in enumerate(pairs):
        rc[i, :len(r)] = nt_codes(r)
        qc[i, :len(q)] = nt_codes(q)
    return rc, qc


# ---------------------------------------------------------------------------
# tests/test_ssw_crosscheck.py
# ---------------------------------------------------------------------------

def test_scorer_matches_vendored_ssw(ssw):  # noqa: F811
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.choice(bases, size=20_000)
    pairs = []
    for _ in range(120):
        p = int(rng.integers(0, len(genome) - 400))
        ref = genome[p:p + 306].tobytes()
        qlen = int(rng.integers(50, 267))
        pairs.append((ref, _ssw_mutate(rng, genome[p + 20:p + 20 + qlen])))
    for _ in range(40):
        p = int(rng.integers(0, len(genome) - 700))
        pairs.append((genome[p:p + 570].tobytes(),
                      _ssw_mutate(rng, genome[p + 235:p + 335])))
    for _ in range(40):
        ref = rng.choice(bases, size=int(rng.integers(1, 300))).tobytes()
        qry = rng.choice(bases, size=int(rng.integers(1, 267))).tobytes()
        pairs.append((ref, qry))
    pairs += [(b"ACGTACGTNNNNNNACGT", b"ACGTNACGT"), (b"NNNNN", b"NNNNN"),
              (b"acgtacgt", b"ACGTACGT"), (b"A", b"A"), (b"A", b"T"),
              (b"ACGT" * 60, b"")]
    ours = score_batch([r for r, _ in pairs], [q for _, q in pairs],
                       device="cpu")
    for i, (ref, qry) in enumerate(pairs):
        want = ssw_score(ssw, ref, qry)
        assert float(ours[i]) == want, (i, float(ours[i]), want)
        assert score_pair_numpy(ref, qry) == want, (i, "numpy twin")
