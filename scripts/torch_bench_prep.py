#!/usr/bin/env python3
"""Pre-generate every bench scale's prep artifacts for the PyTorch/CUDA
port (synthetic genome + read FASTAs, the port's encoded-reference and
k-mer index caches, `ref.fa-enc.torch.npz` and `ref.fa-ht-13-2.torch.npz`),
so a later `python3 scripts/torch_bench.py` pays only cache loads and its
passes, and its ascending ladder reaches the largest scale. The
counterpart of scripts/bench_prep.py.

Runs on the host alone: a Pipeline on the CPU (device="cpu", asked for,
not fallen back to) encodes the reference and builds the index, so the
caches are written with the very parameters the bench's Pipeline loads
them with, and no card is needed. The artifacts land in the work directories the bench uses
(under tempfile.gettempdir()), keyed by (genome_mbp, read_len, n_reads,
n_warmup): run with the same BENCH_* variables as the bench itself.

Usage:  python3 scripts/torch_bench_prep.py [mbp ...]   (default: all scales)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench  # noqa: E402


def main():
    scales = [float(a) for a in sys.argv[1:]] or list(torch_bench.SCALES_MBP)
    from ngmlr_tpu_torch.config import Config
    from ngmlr_tpu_torch.ops import device_engine
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    for mbp in scales:
        t0 = time.time()
        if torch_bench.cache_ready(mbp):
            print("%g Mbp: cache ready (%s)"
                  % (mbp, torch_bench.workdir_for(mbp)), flush=True)
            continue
        tmpdir, ref_path, _, _ = torch_bench.prepare_workdir(mbp)
        print("%g Mbp: FASTAs ready in %.1f s (%s)"
              % (mbp, time.time() - t0, tmpdir), flush=True)
        t0 = time.time()
        Pipeline(Config(), ref_path, use_cache=True, device="cpu")
        # the module's current context would keep this genome in memory
        device_engine.set_current(None)
        print("%g Mbp: encoded ref + index cached in %.1f s"
              % (mbp, time.time() - t0), flush=True)


if __name__ == "__main__":
    main()
