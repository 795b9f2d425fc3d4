"""ngmlr_tpu_torch — the PyTorch/CUDA port of ngmlr_tpu, a long-read DNA
aligner with the capabilities of ngmlr (philres/ngmlr).

The host pipeline (FASTA encode, k-mer index, candidate search, cLIS, the
native C++ assembly engine, CIGAR/MD, SAM) is carried over from ngmlr_tpu
module for module. The device work runs in PyTorch on one CUDA card
through four hand-written CUDA kernels (csrc/): candidate scoring, the
corridor windows, the banded convex-gap fill and its backtrack. Each kernel
has a plain PyTorch version that runs on the CPU, and the port's output is
held byte for byte against ngmlr_tpu and the reference binary's goldens.
"""

__version__ = "0.1.0"


def _tune_allocator():
    """Keep large allocations on the heap instead of per-allocation mmap.

    Sandboxed/virtualized hosts can fault in fresh pages slowly. glibc by
    default mmaps every allocation above 128 KB and returns it to the OS on
    free, so every large numpy buffer / device-to-host copy pays first-touch
    faults again and again. mallopt(M_MMAP_MAX, 0) + an infinite trim
    threshold makes freed pages stay warm in the heap. No-op off glibc.
    """
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4
        libc.mallopt(M_MMAP_MAX, 0)
        libc.mallopt(M_TRIM_THRESHOLD, 2 ** 30)
    except Exception:
        pass


_tune_allocator()
