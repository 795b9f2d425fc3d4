"""The four CUDA kernels of the port against their plain PyTorch versions,
on the card. Marked ``cuda``: every test skips where torch sees no card.
The file imports neither jax nor the test conftest, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ngmlr_tpu_torch.ops import kernels as K  # noqa: E402
from ngmlr_tpu_torch.ops.device_engine import _convex_kernel  # noqa: E402

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = [2.0, -5.0, -5.0, -5.0, -1.0, 0.15]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bufs(dev, seed, G=200_000, R=1 << 15):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.integers(0, 5, G).astype(np.uint8)).to(dev)
    r = torch.from_numpy(rng.integers(0, 5, R).astype(np.uint8)).to(dev)
    return rng, g, r


def _align_rows(rng, B, G, R, Wr, Hr, widths):
    pk = np.zeros((B, 12), np.int32)
    pkf = pk.view(np.float32)
    for b in range(B):
        W, H = int(rng.integers(*Wr)), int(rng.integers(*Hr))
        ds = int(rng.integers(0, G - W - 1))
        mode = b % 4
        width = int(rng.integers(*widths))
        ci, cf = 0, (float(np.float32(H) / np.float32(W)),
                     float(np.float32(width) / np.float32(2.0)))
        if mode == 0:
            ci = int(np.float32(W + 1) * np.float32(-0.2))
            width = W + 1 + int(np.float32(W + 1) * np.float32(0.2))
            cf = (1.0, 0.0)
        elif mode == 1:
            ci, cf = width // 2, (1.0, 0.0)
        pk[b, :10] = (ds, ds + W, 0, W, int(rng.integers(0, R - H - 1)), H,
                      b & 1, mode, ci, width)
        pkf[b, 10:12] = cf
    return pk


def test_score_fill_kernel_matches_plain(dev):
    rng, g, r = _bufs(dev, 1)
    # the hot bucket, a small one, one with several query rows per thread,
    # and one whose reference window passes the default 48 KB of shared
    # memory (the kernel raises its opt-in limit)
    for W, qlen, Rp, Qp, P in ((306, 256, 320, 256, 96), (40, 50, 64, 64, 96),
                               (700, 1500, 1024, 2048, 96),
                               (60000, 300, 65536, 512, 4)):
        pk = np.zeros((P, 7), np.int32)
        pk[:, 0] = rng.integers(0, g.numel() - W - 8, P)
        pk[:, 1] = pk[:, 0] + W
        pk[:, 2] = rng.integers(0, 6, P)
        pk[:, 3], pk[:, 5] = W, qlen
        pk[:, 4] = rng.integers(0, r.numel() - qlen, P)
        pk[:, 6] = np.arange(P) & 1
        pkt = torch.from_numpy(pk).to(dev)
        n0 = K.launches["score_fill"]
        got = K.score_fill(g, r, pkt, Rp, Qp)
        assert K.launches["score_fill"] == n0 + 1
        want = K.score_fill_plain(g, r, pkt, Rp, Qp)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (W, qlen)


def test_corridor_windows_kernel_matches_plain(dev):
    rng = np.random.default_rng(2)
    B, TpP = 100, 2048
    pk = np.zeros((B, 12), np.int32)
    pk[:, 3] = rng.integers(1, 900, B)
    pk[:, 5] = rng.integers(0, 900, B)
    pk[:, 7] = rng.integers(0, 4, B)
    pk[:, 8] = rng.integers(-50, 200, B)
    pk[:, 9] = rng.integers(-20, 400, B)
    pk.view(np.float32)[:, 10] = rng.uniform(0.05, 3.0, B)
    pk.view(np.float32)[:, 11] = rng.uniform(-100, 100, B)
    pkt = torch.from_numpy(pk).to(dev)
    got = K.corridor_windows(pkt, TpP)
    want = K.corridor_windows_plain(pkt, TpP)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Wp,Hp,L", [(1024, 1024, 128), (2048, 1024, 1536),
                                     (512, 512, 12288)])
def test_convex_chain_kernels_match_plain(dev, Wp, Hp, L):
    """L = 12288 keeps the fill's ring buffers in global scratch: they no
    longer fit shared memory."""
    rng, g, r = _bufs(dev, 3)
    pk = _align_rows(rng, 16, g.numel(), r.numel(), (200, Wp),
                     (100, Hp), (24, min(L - 3, 400)))
    pkt = torch.from_numpy(pk).to(dev)
    params = torch.tensor(PARAMS, dtype=torch.float32, device=dev)
    ymin, ymax, hmax = K.corridor_windows(pkt, Wp + Hp)
    dirs, best, by, bx = K.convex_fill(g, r, pkt, params, ymin, ymax, L)
    w_dirs, w_best, w_by, w_bx = K.convex_fill_plain(g, r, pkt, params,
                                                     ymin, ymax, L)
    live = (ymin < pkt[:, 5:6])[:, :, None].expand(-1, -1, L)
    assert torch.equal(dirs[live], w_dirs[live])
    assert torch.equal(best.view(torch.int32), w_best.view(torch.int32))
    assert torch.equal(by, w_by) and torch.equal(bx, w_bx)
    got = K.convex_backtrack(dirs, ymin, pkt, bx, by)
    want = K.convex_backtrack_plain(dirs, ymin, pkt, bx, by)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    packed, scalars = _convex_kernel(g, r, pkt, params, Wp=Wp, Hp=Hp, L=L)
    assert torch.equal(packed, got[0].reshape(-1))
    assert torch.equal(scalars[:, 6], hmax)


def test_golden_test2_on_the_card(dev):
    from ngmlr_tpu_torch.cli import build_parser, config_from_args
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    data = os.path.join(REPO, "tests", "data", "test_2")
    argv = ["-r", os.path.join(data, "ref_chr21_20kb.fa"),
            "-q", os.path.join(data, "reads_100_2200bp.fa")]
    args = build_parser().parse_args(argv)
    p = Pipeline(config_from_args(args, argv), args.reference,
                 use_cache=False, device=dev)
    buf = io.BytesIO()
    K.reset_launches()
    p.run(args.query, buf)
    with open(os.path.join(REPO, "tests", "golden", "test_2.sam"), "rb") as f:
        want = f.read()

    def rec(b):
        return [l for l in b.split(b"\n") if not l.startswith(b"@PG")]
    assert rec(buf.getvalue()) == rec(want)
    assert all(n > 0 for n in K.launches.values()), K.launches
