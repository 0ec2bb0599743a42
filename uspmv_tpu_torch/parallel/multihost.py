"""Multi-process execution: the bootstrap, and the collectives the sharded
operator needs beyond its halo transfer.

Port of ``uspmv_tpu/parallel/multihost.py``. The reference scales across
nodes through MPI: mpirun launches N ranks and MPI_Init wires them up
(main.cpp:1822-1826). The JAX package runs one program per host under
``jax.distributed``, each process holding its local devices; this package
runs its processes under ``torch.distributed``, each process holding the
cards of its share of the host (``local_cards``). Every process runs the
same program: it reads or generates the whole matrix, plans the partition,
the splits, the precisions and the halo exchange of every shard on the host
(deterministic, so bit-equal in every process), and builds device structs
for its own shards only (parallel/distributed.py).

The transport is fixed before the process group starts, never after a
failure:

  * ``backend="cpu"``: gloo, on CPU tensors;
  * ``backend="cuda"`` where every process of a host has a card of its
    own: NCCL, on the cards' own tensors (a failing NCCL start raises);
  * ``backend="cuda"`` where they share (more processes on the host than
    cards): gloo, through pinned host buffers that the operator stages
    explicitly. NCCL refuses two ranks on one device, so this is how
    several processes run on one card, for correctness runs: every
    transfer crosses the host.

A process's cards: with ``count`` visible cards and ``n_local`` processes
on the host (``LOCAL_WORLD_SIZE`` where set, else all of them), c = count
// n_local. Where c >= 1, the process of local rank l (``LOCAL_RANK`` where
set, torchrun's, else its process id) takes cards l*c .. l*c + c - 1, the
first its lead card (``torch.cuda.set_device``, NCCL's ``device_id``);
where c < 1 it takes card ``l % count``, which it shares.
``CUDA_VISIBLE_DEVICES`` is the one way to pin a run to fewer cards. Shards
go to processes as the JAX mesh takes its first R devices of the global,
process-major list: shard r to process ``r // local_devices``, and inside
the process over its cards (parallel/distributed.py).

Result gather (the reference's MPI_Gatherv, main.cpp:968-990): ``to_host``
calls ``fetch_global``, an all-gather, so every process returns the whole y.
"""

from __future__ import annotations

import datetime
import os
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

TIMEOUT_S = 600.0  # a lost peer fails the run after this long

_state: Optional[dict] = None
# the CUDA graphs captured in this run (they may hold NCCL collectives)
_graphs: "weakref.WeakSet" = weakref.WeakSet()


def local_cards(local_rank: int, n_local: int, device_count: int
                ) -> List[int]:
    """The cards of the process of local rank ``local_rank`` among
    ``n_local`` processes of a host with ``device_count`` cards: c =
    device_count // n_local of its own (cards l*c .. l*c + c - 1) where c
    >= 1, else card ``local_rank % device_count``, shared. The first is its
    lead card."""
    c = device_count // n_local
    if c >= 1:
        first = local_rank % n_local * c
        return list(range(first, first + c))
    return [local_rank % device_count]


def transport_for(backend: str, n_local_processes: int,
                  device_count: int) -> str:
    """The transport of a run, from what the host has: "gloo" on the CPU,
    "nccl" where every process of the host has a card of its own
    (``local_cards``: device_count // n_local_processes >= 1), "gloo-staged"
    (gloo through pinned host buffers) where processes share a card.
    backend "cuda" without a card raises DeviceUnavailableError."""
    if backend == "cpu":
        return "gloo"
    if backend != "cuda":
        raise ValueError(f"backend must be 'cuda' or 'cpu', not {backend!r}")
    if device_count < 1:
        from ..runtime.operator import DeviceUnavailableError

        raise DeviceUnavailableError(
            "backend 'cuda' requested but torch sees no CUDA device "
            f"(torch {torch.__version__}); use -backend cpu to run the "
            "processes on the CPU over gloo")
    return ("nccl" if device_count // n_local_processes >= 1
            else "gloo-staged")


def initialize(
    coordinator: Optional[str] = None,
    n_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_devices: Optional[int] = None,
    backend: str = "cuda",
) -> dict:
    """Connect this process to the run. Call once, before the first
    operator. Arguments fall back to USPMV_COORDINATOR / USPMV_N_PROCESSES
    / USPMV_PROCESS_ID; with none of the three, to the launcher's own
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, as torchrun
    sets them).

    ``local_devices``: the shards each process holds (JAX: the devices of
    each process); None takes ceil(R / n_processes) for an operator of R
    shards.

    The process takes the cards of ``local_cards`` (the CPU with backend
    "cpu"), and every process learns every process's cards (one
    all-gather).

    Returns {'process_id', 'n_processes', 'n_devices', 'n_local_devices',
    'transport', 'device', 'devices', 'process_devices'}: n_local_devices
    is ``local_devices`` and n_devices n_processes times it (None where
    ``local_devices`` is); device is the lead card, devices this process's
    cards and process_devices every process's, in process order."""
    global _state
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("USPMV_COORDINATOR")
    if n_processes is None and os.environ.get("USPMV_N_PROCESSES"):
        n_processes = int(os.environ["USPMV_N_PROCESSES"])
    if process_id is None and os.environ.get("USPMV_PROCESS_ID"):
        process_id = int(os.environ["USPMV_PROCESS_ID"])
    if (n_processes is not None or process_id is not None) and not coordinator:
        raise ValueError(
            "-coordinator HOST:PORT is required when -n_processes or "
            "-process_id is given explicitly (process 0's host; under "
            "torchrun omit all three: its environment names the run)"
        )
    if coordinator:
        if n_processes is None or process_id is None:
            raise ValueError("-coordinator needs -n_processes and "
                             "-process_id (or USPMV_N_PROCESSES and "
                             "USPMV_PROCESS_ID)")
        init_method = f"tcp://{coordinator}"
    else:
        init_method = "env://"
        n_processes = int(os.environ.get("WORLD_SIZE", 1))
        process_id = int(os.environ.get("RANK", 0))
    n_processes, process_id = int(n_processes), int(process_id)
    if not 0 <= process_id < n_processes:
        raise ValueError(f"process id {process_id} outside 0.."
                         f"{n_processes - 1}")
    if local_devices is not None and int(local_devices) < 1:
        raise ValueError(f"-local_devices must be >= 1, not {local_devices}")

    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", n_processes))
    count = torch.cuda.device_count() if backend == "cuda" else 0
    transport = transport_for(backend, n_local, count)
    if backend == "cuda":
        devices = [torch.device("cuda", i)
                   for i in local_cards(local_rank, n_local, count)]
        torch.cuda.set_device(devices[0])
    else:
        devices = [torch.device("cpu")]
    dist.init_process_group(
        "nccl" if transport == "nccl" else "gloo",
        init_method=init_method, world_size=n_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        **({"device_id": devices[0]} if transport == "nccl" else {}))
    mine = [str(d) for d in devices]
    every: List[Optional[list]] = [None] * n_processes
    dist.all_gather_object(every, mine)
    _state = dict(
        process_id=process_id,
        n_processes=n_processes,
        n_devices=(None if local_devices is None
                   else n_processes * int(local_devices)),
        n_local_devices=(None if local_devices is None
                         else int(local_devices)),
        transport=transport,
        device=mine[0],
        devices=mine,
        process_devices=every,
    )
    return dict(_state)


def hold_graph(graph) -> None:
    """Keep track of a CUDA graph captured in this run: ``shutdown`` resets
    it before the process group goes, since destroying a communicator
    waits for every live graph that holds its collectives."""
    _graphs.add(graph)


def shutdown() -> None:
    """Leave the run (``destroy_process_group``), after resetting the CUDA
    graphs captured in it (``hold_graph``; they cannot be replayed after);
    a no-op outside one."""
    global _state
    import torch.distributed as dist

    for graph in list(_graphs):
        graph.reset()
    _graphs.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _state = None


def info() -> Optional[dict]:
    """What ``initialize`` returned, or None outside a run of processes."""
    return None if _state is None else dict(_state)


def is_multiprocess() -> bool:
    return _state is not None and _state["n_processes"] > 1


def process_index() -> int:
    return 0 if _state is None else _state["process_id"]


def process_count() -> int:
    return 1 if _state is None else _state["n_processes"]


def transport() -> Optional[str]:
    """"nccl", "gloo" or "gloo-staged"; None outside a run of processes."""
    return None if _state is None else _state["transport"]


def graph_capturable(transport: Optional[str]) -> bool:
    """Whether the transfer of a sharded operator over ``transport`` (None:
    one card group, no transfer; "a+b": the moves between processes, then
    between the cards of a process) can sit inside a CUDA graph. NCCL's
    all-to-all runs on the cards' own tensors and is captured, and so are
    the peer copies between the cards of one process ("peer"); a gloo
    transfer crosses the host, which waits on the copy out before it, so
    gloo and gloo-staged run a loop of launches, and so do copies the
    CUDA stages through the host ("host-staged")."""
    if transport is None:
        return True
    return all(t in ("nccl", "peer") for t in transport.split("+"))


def agree_max(value: float) -> float:
    """The largest ``value`` of all processes (every process calls it);
    ``value`` itself outside a run of processes."""
    if not is_multiprocess():
        return value
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if transport() == "nccl" else torch.device("cpu"))
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def gather_object(obj) -> list:
    """Every process's ``obj`` (picklable), in process order (a collective:
    every process calls it); ``[obj]`` outside a run of processes."""
    if not is_multiprocess():
        return [obj]
    import torch.distributed as dist

    out: List[object] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def all_gather_blocks(local: torch.Tensor, dim: int,
                      counts: Sequence[int]) -> torch.Tensor:
    """The concatenation along ``dim`` of every process's ``local`` block,
    in process order, on local's device; process q's block holds
    ``counts[q]`` entries along ``dim`` (blocks are padded to the largest
    count for the all-gather and cut back)."""
    import torch.distributed as dist

    width = max(counts)
    block = local.movedim(dim, 0)
    if block.shape[0] < width:
        pad = block.new_zeros((width - block.shape[0],) + block.shape[1:])
        block = torch.cat([block, pad])
    block = block.contiguous()
    if block.device.type == "cuda" and transport() != "nccl":
        block = block.cpu()  # gloo takes host tensors
    parts: List[torch.Tensor] = [torch.empty_like(block) for _ in counts]
    dist.all_gather(parts, block)
    out = torch.cat([p[:n] for p, n in zip(parts, counts)])
    return out.to(local.device).movedim(0, dim)


def fetch_global(local: torch.Tensor, dim: int = 0,
                 counts: Optional[Sequence[int]] = None) -> np.ndarray:
    """The process_allgather analogue: every process's ``local`` rows
    (its shards along ``dim``) concatenated in process order, as a numpy
    array on every process (a collective: every process calls it).
    ``counts``: the shards of each process (default: as many as here, in
    every process). Outside a run of processes: ``local`` on the host."""
    if not is_multiprocess():
        return local.detach().cpu().numpy()
    if counts is None:
        counts = [local.shape[dim]] * process_count()
    return all_gather_blocks(local.detach(), dim, counts).cpu().numpy()
