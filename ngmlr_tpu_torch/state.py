"""The port's mapping state built from plain numpy arrays.

The mapper carries no weights: its state is the encoded genome with its
contig table, the k-mer index and the score parameters. ``from_numpy``
builds the port's ``ReferenceGenome``, ``KmerIndex`` and device
score-parameter vector from the arrays that any other holder of the same
state (for instance the JAX package's objects) exposes, so two
implementations can be given identical state.
"""

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .index.kmer_index import KmerIndex
from .io.reference import ReferenceGenome
from .ops.device_engine import resolve_device


@dataclass
class MappingState:
    ref: ReferenceGenome
    index: KmerIndex
    params: torch.Tensor        # f32 [6]: mat, mis, go, ge, gemin, gdecay


def from_numpy(codes: np.ndarray, ref_start_pos: np.ndarray,
               names: Sequence[bytes], lengths: np.ndarray,
               bucket_starts: np.ndarray, positions: np.ndarray,
               params: Sequence[float], *, k: int = 13, kmer_skip: int = 2,
               bin_size: int = 4, uniq_prefix: Optional[np.ndarray] = None,
               device=None) -> MappingState:
    """codes uint8 [G] (A=0,T=1,G=2,C=3,N=4); ref_start_pos int64 [n + 1]
    contig starts in the concatenated coordinates plus the terminator;
    names/lengths per contig; bucket_starts int64 (dense [4^k + 1], or
    sparse [u + 1] over ``uniq_prefix``) and positions (uint32 as the index
    build stores them) of the k-mer index; params the six convex score
    parameters. The index arrays keep the dtypes they are given."""
    dev = resolve_device(device)
    ref = ReferenceGenome(np.ascontiguousarray(codes, dtype=np.uint8),
                          [bytes(n) for n in names],
                          np.asarray(ref_start_pos[:-1], dtype=np.int64),
                          np.asarray(lengths, dtype=np.int64))
    if not np.array_equal(ref.ref_start_pos,
                          np.asarray(ref_start_pos, dtype=np.int64)):
        raise ValueError("ref_start_pos terminator does not match the "
                         "contig table")
    index = KmerIndex(k, np.asarray(bucket_starts), np.asarray(positions),
                      bin_size, kmer_skip,
                      uniq_prefix=None if uniq_prefix is None
                      else np.asarray(uniq_prefix))
    pvec = torch.tensor(np.asarray(params, dtype=np.float32), device=dev)
    return MappingState(ref, index, pvec)
