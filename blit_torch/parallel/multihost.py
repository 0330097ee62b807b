"""Multi-process bring-up of a ``(band, bank)`` pod over
``torch.distributed``.

Counterpart of ``blit/parallel/multihost.py``.  ``blit`` brings up the
JAX distributed runtime and maps its global device list onto
``(band, bank)`` players; here one process group carries the pod's
collectives and each process seats its players on its own devices
(:func:`blit_torch.parallel.mesh.make_mesh`).

- :func:`init_multihost` is idempotent.  With no coordinator (and no
  ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK`` in the environment) it
  leaves the process single; an explicit coordinator never degrades to
  one process: a failed bring-up raises.
- ``backend`` stands where ``blit`` has ``cpu_collectives``: ``"nccl"``
  by default for CUDA players, ``"gloo"`` on the CPU.  NCCL cannot seat
  two ranks on one GPU, so a ``"nccl"`` pod whose ranks share a card
  raises a ``ValueError`` naming that rule before any communicator is
  built; such a pod runs ``backend="gloo"``.
- gloo has no ``all_gather`` for CUDA tensors, so :func:`all_gather_tensor`
  stages a CUDA operand through pinned host memory, explicitly, and
  reports the bytes it staged.

The seats (host and device of every rank) are exchanged through the
pod's ``TCPStore`` before the process group is made, so the NCCL rule
is checked on every rank alike and every rank raises together.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from blit_torch.device import resolve_device
from blit_torch.observability import hostname

log = logging.getLogger("blit_torch.multihost")

BACKENDS = ("nccl", "gloo")

# Environment markers of a launcher-made cluster (torchrun's).
_CLUSTER_ENV_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")

_STATE: Dict = {"initialized": False, "active": False, "rank": 0,
                "world": 1, "backend": None, "device": None,
                "address": None}


def _cluster_env() -> Optional[Tuple[str, int, int]]:
    if not all(os.environ.get(v) for v in _CLUSTER_ENV_VARS):
        return None
    port = os.environ.get("MASTER_PORT", "29500")
    return (f"{os.environ['MASTER_ADDR']}:{port}",
            int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]))


def _split_address(address: str) -> Tuple[str, int]:
    addr = address[len("tcp://"):] if address.startswith("tcp://") else address
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port, got {address!r}")
    return host, int(port)


def seat_id(device) -> str:
    """Which physical device a rank's players sit on: the host and, for a
    CUDA device this process can see, the card's UUID (so two ranks that
    name the same card through different ``CUDA_VISIBLE_DEVICES`` still
    compare equal)."""
    dev = torch.device(device)
    ident = str(dev)
    if dev.type == "cuda" and torch.cuda.is_available():
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        uuid = getattr(torch.cuda.get_device_properties(idx), "uuid", None)
        ident = f"cuda-uuid:{uuid}" if uuid is not None else f"cuda:{idx}"
    return f"{hostname()}|{ident}"


def check_nccl_seats(seats: Sequence[str]) -> None:
    """NCCL seats one rank per GPU: raise ``ValueError`` naming the rule
    when two ranks of an ``"nccl"`` pod share a card (or a rank has no
    CUDA device)."""
    owners: Dict[str, List[int]] = {}
    for rank, seat in enumerate(seats):
        if "|cpu" in seat:
            raise ValueError(
                f"backend='nccl' needs a CUDA device on every rank; rank "
                f"{rank} sits on {seat.split('|', 1)[1]} (use backend='gloo')")
        owners.setdefault(seat, []).append(rank)
    shared = {s: r for s, r in owners.items() if len(r) > 1}
    if shared:
        what = "; ".join(f"ranks {r} on {s.split('|', 1)[1]}"
                         for s, r in sorted(shared.items()))
        raise ValueError(
            "NCCL cannot seat two ranks on one GPU (one communicator rank "
            f"per device): {what}. Give each rank its own card, or run the "
            "pod with backend='gloo', which stages its collectives through "
            "pinned host memory")


def _exchange_seats(store, rank: int, world: int, seat: str) -> List[str]:
    store.set(f"blit/seat/{rank}", seat)
    return [store.get(f"blit/seat/{r}").decode() for r in range(world)]


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None, *,
                   device=None, timeout_s: float = 300.0) -> bool:
    """Bring up the pod's process group (idempotent).  Returns True when
    more than one process is in it.

    ``coordinator_address`` (``host:port`` or ``tcp://host:port``) is
    the rendezvous, served by ``process_id`` 0; ``num_processes`` and
    ``process_id`` must come with it.  ``device`` is where this process
    seats its players (default: the current CUDA device, which raises
    without a GPU; the CPU is ``device="cpu"``); ``backend`` defaults to
    ``"nccl"`` for a CUDA device and ``"gloo"`` for the CPU.  A one-process pod with a coordinator builds
    its group too (its collectives run for real)."""
    import torch.distributed as dist

    if _STATE["initialized"]:
        if coordinator_address is not None and (
                num_processes != _STATE["world"]
                or process_id != _STATE["rank"]):
            raise ValueError(
                f"init_multihost: this process is already rank "
                f"{_STATE['rank']} of a {_STATE['world']}-process pod; "
                f"asked for rank {process_id} of {num_processes}")
        return _STATE["active"]
    if coordinator_address is None:
        env = _cluster_env()
        if env is None:
            if num_processes not in (None, 1) or process_id not in (None, 0):
                raise ValueError(
                    "init_multihost: num_processes/process_id name a pod; "
                    "pass its coordinator_address too")
            log.info("no cluster configured; single-process mode")
            _STATE.update(initialized=True, active=False, rank=0, world=1)
            return False
        coordinator_address, num_processes, process_id = env
    if num_processes is None or process_id is None:
        raise ValueError("init_multihost: an explicit coordinator needs "
                         "num_processes and process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside a "
                         f"{num_processes}-process pod")
    if dist.is_initialized():
        raise RuntimeError(
            "a torch.distributed process group is already up; the pod's "
            "group must be made by init_multihost")
    # The default is the card (raising without one); a named device is
    # taken as given, so the seat rules are checked before any CUDA use.
    dev = resolve_device(None) if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if torch.cuda.is_available() else 0)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    host, port = _split_address(coordinator_address)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, port, num_processes,
                          is_master=process_id == 0, timeout=timeout)
    seats = _exchange_seats(store, process_id, num_processes, seat_id(dev))
    if backend == "nccl":
        check_nccl_seats(seats)
        if not dist.is_nccl_available():
            raise RuntimeError("backend='nccl' asked for, but this torch "
                               "build has no NCCL")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _STATE.update(initialized=True, active=num_processes > 1,
                  rank=process_id, world=num_processes, backend=backend,
                  device=dev, address=coordinator_address, seats=seats)
    log.info("process group up: rank %d of %d, backend %s, device %s",
             process_id, num_processes, backend, dev)
    return num_processes > 1


def shutdown() -> None:
    """Tear the pod's process group down (idempotent); the process is
    single again afterwards."""
    import torch.distributed as dist

    if dist.is_initialized() and _STATE.get("backend") is not None:
        dist.destroy_process_group()
    _STATE.update(initialized=False, active=False, rank=0, world=1,
                  backend=None, device=None, address=None)


def in_pod() -> bool:
    """Whether this process belongs to a process group made by
    :func:`init_multihost` (one process counts)."""
    return _STATE.get("backend") is not None


def process_index() -> int:
    return int(_STATE["rank"])


def process_count() -> int:
    return int(_STATE["world"])


def backend() -> Optional[str]:
    return _STATE.get("backend")


def pod_device() -> Optional[torch.device]:
    """The device this rank declared at bring-up (NCCL's tensors live
    there)."""
    return _STATE.get("device")


def local_devices() -> List[torch.device]:
    """The devices this process seats players on by default: every
    visible CUDA device.  Raises without a GPU, as every entry point
    does; players on the CPU are asked for by a device list."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def all_gather_object(obj) -> List:
    """Every rank's ``obj``, in rank order (``[obj]`` outside a pod)."""
    if not in_pod():
        return [obj]
    import torch.distributed as dist

    out: List = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def all_gather_tensor(t: torch.Tensor) -> Tuple[List[torch.Tensor], int]:
    """Every rank's ``t`` (equal shapes), in rank order, on ``t``'s
    device, and the bytes staged through host memory for it.  NCCL takes
    the tensor on the rank's card; gloo takes host tensors, so a CUDA
    operand is copied into pinned host memory first and the gathered
    blocks copied back (both counted)."""
    if not in_pod():
        return [t], 0
    import torch.distributed as dist

    t = t.contiguous()
    staged = 0
    if backend() == "nccl":
        work = t.to(pod_device())
    elif t.device.type == "cuda":
        work = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        work.copy_(t)
        staged += t.numel() * t.element_size()
    else:
        work = t
    out = [torch.empty_like(work) for _ in range(process_count())]
    dist.all_gather(out, work)
    if work.device != t.device:
        if t.device.type == "cuda" and backend() != "nccl":
            staged += sum(o.numel() * o.element_size() for o in out)
        # Host-to-card copies may overlap; a copy to the host must land
        # before the caller reads it.
        out = [o.to(t.device, non_blocking=t.device.type == "cuda") for o in out]
    return out, staged


def player_map(mesh) -> Dict[Tuple[int, int], torch.device]:
    """``{(band, bank): device}``: which device plays which
    ``BLP<band><bank>``."""
    nband, nbank = mesh.devices.shape
    return {(b, k): mesh.devices[b, k] for b in range(nband)
            for k in range(nbank)}


def local_players(mesh) -> List[Tuple[int, int]]:
    """The ``(band, bank)`` players seated on this process: the banks
    whose files it feeds."""
    me = process_index()
    nband, nbank = mesh.devices.shape
    return [(b, k) for b in range(nband) for k in range(nbank)
            if int(mesh.ranks[b, k]) == me]
