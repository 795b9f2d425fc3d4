"""Scale-out: data parallelism over reads, within a process and across
processes.

The port's replacement for the reference's pthread worker pool
(NGM.cpp:334-348):

  * within a process, -t N runs every score and align wave over a mesh of
    N devices (ops/device_engine.py): the genome and each read buffer are
    replicated on every device, each wave's problems are split into
    contiguous per-device shards and the results gathered back in problem
    order. The mesh is a plain list of torch.device, one entry per shard;
    entries may repeat (shards sharing one device),
  * across processes (one per host or per card group), torch.distributed
    only bootstraps the run and assigns each process its read shard; every
    process maps its slice of the input file and writes its own SAM, and
    scripts/merge_sams.py merges the shards deterministically. No
    collective runs on the device, so the gloo backend serves on the CPU
    and beside the cards alike.
"""

import os
import sys
from datetime import timedelta
from typing import List, Optional

import torch

# how long a process waits for the others to join the process group
RENDEZVOUS_TIMEOUT_S = 600.0


def make_mesh(n_devices: Optional[int] = None, device="cuda"
              ) -> List[torch.device]:
    """The devices of an n_devices-wide wave mesh starting at `device`:
    "cuda" expands to cuda:0 .. cuda:N-1 ("cuda:i" to cuda:i ..); the CPU
    is one device. A request past the visible devices is clamped to them
    with a warning (never moved to another kind of device)."""
    dev = torch.device(device)
    nd = max(int(n_devices or 1), 1)
    if dev.type == "cuda":
        base = dev.index or 0
        avail = max(torch.cuda.device_count() - base, 1)
    else:
        avail = 1
    if nd > avail:
        sys.stderr.write("ngmlr-tpu: %d devices requested, %d available — "
                         "using %d\n" % (nd, avail, avail))
        nd = avail
    if dev.type == "cuda":
        return [torch.device("cuda", base + i) for i in range(nd)]
    return [dev]


def _env_int(*names) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v)
    return None


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """Multi-process bootstrap: one ngmlr-tpu process per host (or per
    group of cards), reads data-parallel across processes (each maps every
    Nth read; the outputs merge with scripts/merge_sams.py).

    Coordination comes from the arguments or the environment:
    NGMLR_TPU_COORDINATOR=host:port, NGMLR_TPU_NUM_PROCS and
    NGMLR_TPU_PROC_ID; where those are unset, torchrun's MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK. Process 0 serves the rendezvous at
    host:port. No coordinator and at most one process => single-process
    no-op, returns (0, 1). More than one process without a coordinator, a
    coordinator without a process count or id, or a rendezvous not
    complete within RENDEZVOUS_TIMEOUT_S raises: there is no quiet
    single-process run.

    Returns (process_index, process_count)."""
    coordinator = coordinator or os.environ.get("NGMLR_TPU_COORDINATOR")
    if not coordinator and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator = "%s:%s" % (os.environ["MASTER_ADDR"],
                                 os.environ["MASTER_PORT"])
    if num_processes is None:
        num_processes = _env_int("NGMLR_TPU_NUM_PROCS", "WORLD_SIZE")
    if not coordinator:
        if num_processes is not None and num_processes > 1:
            raise RuntimeError(
                "%d processes but no coordinator: set NGMLR_TPU_COORDINATOR"
                " (or MASTER_ADDR and MASTER_PORT)" % num_processes)
        return 0, 1
    if process_id is None:
        process_id = _env_int("NGMLR_TPU_PROC_ID", "RANK")
    if num_processes is None or process_id is None:
        raise RuntimeError(
            "coordinator %s set, but the process count or id is not: set "
            "NGMLR_TPU_NUM_PROCS and NGMLR_TPU_PROC_ID (or WORLD_SIZE and "
            "RANK)" % coordinator)
    if not 0 <= process_id < num_processes:
        raise ValueError("process id %d outside 0..%d"
                         % (process_id, num_processes - 1))
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    return dist.get_rank(), dist.get_world_size()


def local_device(device: str, width: int) -> str:
    """The first device of this process's mesh. Under torchrun, which
    starts several processes on one node with the same visible cards,
    process LOCAL_RANK=L takes its own `width` cards, cuda:L*width ..;
    a bare "cuda" is otherwise cuda:0 and any other device stays as given
    (split the cards with CUDA_VISIBLE_DEVICES there). Raises when the
    process's first card is not visible."""
    local = _env_int("LOCAL_RANK")
    if not local or device != "cuda":
        return device
    width = max(int(width or 1), 1)
    base = local * width
    n = torch.cuda.device_count()
    if base >= n:
        raise RuntimeError(
            "local rank %d with %d card(s) each starts at cuda:%d, but %d "
            "card(s) are visible" % (local, width, base, n))
    return "cuda:%d" % base


def shutdown_distributed():
    """Destroy the process group init_distributed made, if any."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
