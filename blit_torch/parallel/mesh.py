"""The BL@GBT ``(band, bank)`` topology as a mesh of players.

Counterpart of ``blit/parallel/mesh.py``.  ``blit`` lays the topology
over a ``jax.sharding.Mesh`` and runs every step under ``shard_map``;
here a :class:`Mesh` is a ``(band, bank)`` grid of players, each with its
owning process rank and its ``torch.device``, and a :class:`MeshArray`
holds a global array as the shards of this process's players.

- The per-player body is the single-device reduction: each local player
  runs the port's :func:`~blit_torch.ops.channelize.channelize` on its
  own bank's block, the kernel path.
- The bank stitch is a gather along the channel axis.  Between players
  of one process it is a device-side concatenation (peer copies where
  the devices differ); a band row that spans processes gathers through
  the process group (:func:`pod_gather`, an ``all_gather``).
- ``psum`` (the beamformer's antenna sum, the correlator's band sum) adds
  the players' partials in a fixed order, axis index ascending, so a
  product does not depend on how the players are spread over processes.
- Several players may share one device: an explicit device list may
  repeat a device (the tests seat 8 players on ``cpu``; the card seats
  them on ``cuda:0``).

Every array role names its split in :data:`PARTITION_RULES` (``blit``'s
registry: which axis of each role is split over ``band`` / ``bank``).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from blit_torch.ops.channelize import channelize
from blit_torch.ops.despike import despike
from blit_torch.parallel import multihost

BAND_AXIS = "band"
BANK_AXIS = "bank"
AXES = (BAND_AXIS, BANK_AXIS)

Player = Tuple[int, int]


class PartitionSpec(tuple):
    """Which mesh axis splits each dimension of an array (None:
    replicated), ``blit``'s ``PartitionSpec``; trailing dimensions not
    named are replicated."""

    def __new__(cls, *axes):
        for a in axes:
            if a not in (None,) + AXES:
                raise ValueError(f"unknown mesh axis {a!r}")
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


P = PartitionSpec

PARTITION_RULES: Dict[str, PartitionSpec] = {
    # int8 voltage blocks (nband, nbank, nchan, ntime, npol, 2): one
    # (band, bank) block a player.
    "voltages": P(BAND_AXIS, BANK_AXIS),
    # Small operands every player holds whole (PFB coefficients).
    "replicated": P(),
    # Products (nband, ntime, nif, nchans): channels over bank before
    # the stitch, the whole band on every player of the row after it.
    "filterbank_sharded": P(BAND_AXIS, None, None, BANK_AXIS),
    "filterbank_stitched": P(BAND_AXIS, None, None, None),
    # Packed hit tables (nband, nbank, nbands, k, 4), one a player.
    "packed_hits": P(BAND_AXIS, BANK_AXIS),
    # Fold accumulators: the beam power after its psum (replicated); the
    # correlator's partial visibilities, one band block a row and the
    # channels over bank, standard (nband, a, b, c, f, p, q) or packed
    # (nband, c, f, a, p, b, q).
    "beamform_acc": P(),
    "vis_acc_standard": P(BAND_AXIS, None, None, BANK_AXIS),
    "vis_acc_packed": P(BAND_AXIS, BANK_AXIS),
}

# The collective-latency histograms of the sharded plane.
MESH_HISTS = ("mesh.gather_s", "mesh.psum_s")


def partition_rule(role: Union[str, PartitionSpec]) -> PartitionSpec:
    """The registry's spec for ``role`` (a spec passes through)."""
    if isinstance(role, str):
        try:
            return PARTITION_RULES[role]
        except KeyError:
            raise KeyError(f"unknown partition rule {role!r}; known roles: "
                           f"{sorted(PARTITION_RULES)}") from None
    return role


def gather_ici_bytes(shard_bytes: int, axis_size: int) -> int:
    """Bytes one player receives in an ``all_gather`` over an axis of
    ``axis_size``: every other shard of its row, ``(axis_size - 1) *
    shard_bytes``."""
    return max(0, axis_size - 1) * shard_bytes


def psum_ici_bytes(nbytes: int, axis_size: int) -> int:
    """Bytes one player receives in a ring ``psum`` of an ``nbytes``
    operand: ``2 * (n-1)/n * nbytes``."""
    if axis_size <= 1:
        return 0
    return int(2 * (axis_size - 1) * nbytes // axis_size)


def record_ici(timeline, collective: str, nbytes: int,
               seconds: Optional[float] = None) -> None:
    """Account one collective on a Timeline: bytes on the ``mesh.ici``
    stage, a sample of ``mesh.<collective>_ici_bytes`` and, when the
    caller timed the collective alone, of ``mesh.<collective>_s``.
    ``collective`` is ``"gather"`` or ``"psum"``."""
    s = timeline.stages["mesh.ici"]
    s.calls += 1
    s.bytes += int(nbytes)
    timeline.observe(f"mesh.{collective}_ici_bytes", float(nbytes))
    if seconds is not None:
        s.seconds += seconds
        timeline.observe(f"mesh.{collective}_s", seconds)


class Mesh:
    """A ``(band, bank)`` grid of players: ``devices[b, k]`` is the
    ``torch.device`` that plays ``BLP<b><k>`` and ``ranks[b, k]`` the
    process that owns it.  ``shape`` maps an axis name to its size."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, ranks: np.ndarray):
        self.devices = devices
        self.ranks = ranks
        nband, nbank = devices.shape
        self.shape = {BAND_AXIS: nband, BANK_AXIS: nbank}
        self.size = nband * nbank

    def __repr__(self) -> str:
        return (f"Mesh(band={self.shape[BAND_AXIS]}, bank="
                f"{self.shape[BANK_AXIS]}, processes="
                f"{len(set(self.ranks.ravel().tolist()))})")

    def players(self) -> List[Player]:
        nband, nbank = self.devices.shape
        return [(b, k) for b in range(nband) for k in range(nbank)]

    def local_players(self) -> List[Player]:
        return multihost.local_players(self)

    def is_local(self, player: Player) -> bool:
        return int(self.ranks[player]) == multihost.process_index()

    def nprocs(self) -> int:
        return len(set(self.ranks.ravel().tolist()))

    def spans_processes(self, axis: str) -> bool:
        """Whether some group along ``axis`` (a band row for ``bank``, a
        bank column for ``band``) has players on more than one process."""
        r = self.ranks if axis == BANK_AXIS else self.ranks.T
        return any(len(set(row.tolist())) > 1 for row in r)


def make_mesh(nband: int = 1, nbank: int = 8,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(band, bank)`` mesh over the first ``nband*nbank`` devices of
    the pod, players row-major (bank minor).

    ``devices`` is this process's device list (default
    :func:`~blit_torch.parallel.multihost.local_devices`, the visible
    cards, which raises without a GPU; ``["cpu"] * n`` seats players on
    the CPU); it may repeat a device to seat several players on it.  In a pod every process
    passes its own list and the global list is the ranks' lists in rank
    order.  Raises when the pod has fewer devices than players."""
    local = [torch.device(d) for d in (
        devices if devices is not None else multihost.local_devices())]
    per_rank = multihost.all_gather_object([str(d) for d in local])
    glob = [(rank, torch.device(d)) for rank, devs in enumerate(per_rank)
            for d in devs]
    n = nband * nbank
    if len(glob) < n:
        raise ValueError(f"need {n} devices for a {nband}x{nbank} mesh, "
                         f"have {len(glob)}")
    devs = np.empty((nband, nbank), dtype=object)
    ranks = np.empty((nband, nbank), dtype=np.int64)
    for i, (r, d) in enumerate(glob[:n]):
        devs[i // nbank, i % nbank] = d
        ranks[i // nbank, i % nbank] = r
    return Mesh(devs, ranks)


class NamedSharding:
    """A spec placed on a mesh (``blit``'s ``NamedSharding``):
    :func:`device_put` splits a host or device array by it."""

    def __init__(self, mesh: Mesh, spec: Union[str, PartitionSpec]):
        self.mesh = mesh
        self.spec = partition_rule(spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def sharding_for(mesh: Mesh, role: Union[str, PartitionSpec]) -> NamedSharding:
    return NamedSharding(mesh, role)


def voltage_sharding(mesh: Mesh) -> NamedSharding:
    """Voltages ``(nband, nbank, nchan, ntime, npol, 2)``: one block a
    player."""
    return sharding_for(mesh, "voltages")


def filterbank_sharding(mesh: Mesh, stitched: bool) -> NamedSharding:
    """Products ``(nband, ntime, nif, nchans)``: channels over ``bank``
    (unstitched) or whole on every player of the row (stitched)."""
    return sharding_for(mesh, "filterbank_stitched" if stitched
                        else "filterbank_sharded")


def shard_index(spec: PartitionSpec, mesh: Mesh, player: Player,
                shape: Sequence[int]) -> Tuple[slice, ...]:
    """The slices of a global array of ``shape`` that ``player``'s
    shard covers under ``spec``."""
    idx = []
    for dim, n in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            idx.append(slice(None))
            continue
        parts = mesh.shape[axis]
        if n % parts:
            raise ValueError(f"dimension {dim} ({n}) does not split over the "
                             f"{parts}-way {axis!r} axis")
        pos = player[0] if axis == BAND_AXIS else player[1]
        step = n // parts
        idx.append(slice(pos * step, (pos + 1) * step))
    return tuple(idx)


class MeshArray:
    """A global array of ``shape`` split over ``mesh`` by ``spec``: the
    shards of this process's players, each on its player's device
    (players on one device may share a replicated shard)."""

    def __init__(self, mesh: Mesh, spec: Union[str, PartitionSpec],
                 shape: Sequence[int], shards: Dict[Player, torch.Tensor]):
        self.mesh = mesh
        self.spec = partition_rule(spec)
        self.shape = tuple(int(n) for n in shape)
        self.shards = shards

    def __repr__(self) -> str:
        return (f"MeshArray(shape={self.shape}, spec={self.spec!r}, "
                f"local={sorted(self.shards)})")

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    @property
    def nbytes(self) -> int:
        n = int(np.prod(self.shape))
        return n * torch.empty((), dtype=self.dtype).element_size()

    def shard(self, player: Player) -> torch.Tensor:
        return self.shards[player]

    def synchronize(self) -> None:
        """Wait for the work that produces every local shard."""
        done = set()
        for t in self.shards.values():
            if t.device.type == "cuda" and t.device not in done:
                torch.cuda.synchronize(t.device)
                done.add(t.device)

    def numpy(self) -> np.ndarray:
        """The whole global array on the host; every part of it must be
        held by a local shard."""
        by_band = BAND_AXIS in self.spec
        by_bank = BANK_AXIS in self.spec
        nband, nbank = self.mesh.devices.shape
        need = {(b if by_band else 0, k if by_bank else 0)
                for b in range(nband) for k in range(nbank)}
        out = None
        for player, t in sorted(self.shards.items()):
            key = (player[0] if by_band else 0, player[1] if by_bank else 0)
            if key not in need:
                continue
            h = t.detach().cpu().numpy()
            if out is None:
                out = np.empty(self.shape, dtype=h.dtype)
            out[shard_index(self.spec, self.mesh, player, self.shape)] = h
            need.discard(key)
        if out is None or need:
            raise ValueError(f"parts {sorted(need)} are not held by this "
                             "process; the global array is not local")
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def device_put(x, sharding: NamedSharding):
    """Split ``x`` (a NumPy array or tensor, or a planar pair of them)
    over ``sharding``'s mesh: each local player gets its block on its
    device.  A pair gives a pair."""
    if isinstance(x, tuple):
        return tuple(device_put(a, sharding) for a in x)
    mesh, spec = sharding.mesh, sharding.spec
    t = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
    shards: Dict[Player, torch.Tensor] = {}
    on_dev: Dict[Tuple[Tuple, torch.device], torch.Tensor] = {}
    for p in mesh.local_players():
        idx = shard_index(spec, mesh, p, t.shape)
        dev = mesh.devices[p]
        key = (tuple((s.start, s.stop) for s in idx), dev)
        if key not in on_dev:
            on_dev[key] = t[idx].to(dev, non_blocking=dev.type == "cuda").contiguous()
        shards[p] = on_dev[key]
    return MeshArray(mesh, spec, t.shape, shards)


def shard_voltages(voltages, mesh: Mesh) -> MeshArray:
    """Place a host ``(nband, nbank, ...)`` voltage array onto the mesh,
    one block a player."""
    return device_put(voltages, voltage_sharding(mesh))


def put_local_shards(blocks: Dict[Player, Union[np.ndarray, torch.Tensor]],
                     mesh: Mesh, global_shape,
                     role: Union[str, PartitionSpec] = "voltages") -> MeshArray:
    """The global array of ``role`` from one host block per local player
    (leading ``(1, 1, ...)`` block axes present), each copied straight to
    its player's device (``non_blocking`` from pinned memory)."""
    shards = {}
    for p, blk in sorted(blocks.items()):
        t = torch.from_numpy(blk) if isinstance(blk, np.ndarray) else blk
        dev = mesh.devices[p]
        shards[p] = t.to(dev, non_blocking=dev.type == "cuda")
    return MeshArray(mesh, role, global_shape, shards)


def pod_gather(mesh: Mesh, local: Dict[Player, torch.Tensor],
               timeline=None) -> Tuple[Dict[Player, torch.Tensor], int]:
    """Every player's tensor on this process, from each process's local
    ones: the pod's ``all_gather`` (every rank must call it, with equal
    local counts and shapes).  Returns the full dict and the bytes
    staged through host memory.  Outside a pod it returns ``local``."""
    if mesh.nprocs() == 1:
        return dict(local), 0
    mine = sorted(local)
    stack = torch.stack([local[p] for p in mine])
    blocks, staged = multihost.all_gather_tensor(stack)
    out: Dict[Player, torch.Tensor] = {}
    players = mesh.players()
    for rank, blk in enumerate(blocks):
        theirs = [p for p in players if int(mesh.ranks[p]) == rank]
        if len(theirs) != blk.shape[0]:
            raise ValueError("pod_gather: processes hold unequal player counts")
        for i, p in enumerate(theirs):
            out[p] = blk[i]
    if timeline is not None and staged:
        timeline.stages["mesh.host_stage"].bytes += staged
    return out, staged


def psum_groups(mesh: Mesh, partials: Dict[Player, Tuple[torch.Tensor, ...]],
                axis: str, timeline=None) -> Dict[int, Tuple[torch.Tensor, ...]]:
    """``psum`` over ``axis``: for every group along it (keyed by the
    other axis's index) the sum of its players' partials (tuples of
    tensors), added in axis-index order on the device of the group's
    first player.  In a pod the partials travel by :func:`pod_gather`
    first; every rank gets every group."""
    staged = 0
    if mesh.nprocs() > 1:
        ncomp = len(next(iter(partials.values())))
        full: Dict[Player, List[torch.Tensor]] = {}
        for c in range(ncomp):
            got, s = pod_gather(mesh, {p: v[c] for p, v in partials.items()},
                                timeline)
            staged += s
            for p, t in got.items():
                full.setdefault(p, []).append(t)
        partials = {p: tuple(v) for p, v in full.items()}
    nband, nbank = mesh.devices.shape
    out: Dict[int, Tuple[torch.Tensor, ...]] = {}
    if axis == BANK_AXIS:
        groups = {b: [(b, k) for k in range(nbank)] for b in range(nband)}
    elif axis == BAND_AXIS:
        groups = {k: [(b, k) for b in range(nband)] for k in range(nbank)}
    else:
        raise ValueError(f"unknown mesh axis {axis!r}")
    for g, members in groups.items():
        if not all(p in partials for p in members):
            continue
        dev = partials[members[0]][0].device
        acc = None
        for p in members:
            part = tuple(t.to(dev, non_blocking=True) for t in partials[p])
            acc = part if acc is None else tuple(a + b for a, b in zip(acc, part))
        out[g] = acc
    return out


def band_reduce(voltages: MeshArray, coeffs, *, mesh: Mesh, nfft: int,
                ntap: int = 4, nint: int = 1, stokes: str = "I",
                fft_method: str = "auto", stitch: bool = True,
                despike_nfpc: int = 0, fqav_by: int = 1,
                dtype: str = "float32", timeline=None) -> MeshArray:
    """The whole mesh reduction step: every local player channelizes
    its own bank's block, then the banks of each band stitch their fine
    spectra into one band.

    ``voltages``: int8 ``(nband, nbank, nchan, ntime, npol, 2)``, one
    block a player (:func:`voltage_sharding`).  ``stitch=False`` leaves
    the product split over ``bank`` and runs no collective.
    ``despike_nfpc >= 2`` repairs each coarse channel's DC fine channel
    after the stitch (in output channels: ``nfft // fqav_by``; coarse
    channels never straddle banks, so the split product is repaired per
    player).  ``fqav_by`` averages on each player before the stitch, so
    the gather moves ``fqav_by`` times fewer bytes.  ``dtype`` is the
    channelizer's working dtype; the product is f32 either way.

    Returns f32 ``(nband, ntime_out, nif, nchans)``: the whole band on
    every player of its row (stitched) or the channels over ``bank``."""
    nband, nbank = mesh.devices.shape
    co: Dict[torch.device, torch.Tensor] = {}
    shards: Dict[Player, torch.Tensor] = {}
    for p, v in sorted(voltages.shards.items()):
        dev = mesh.devices[p]
        if dev not in co:
            co[dev] = torch.as_tensor(coeffs).to(dev)
        out = channelize(v[0, 0], co[dev], nfft=nfft, ntap=ntap, nint=nint,
                         stokes=stokes, fft_method=fft_method, dtype=dtype,
                         fqav_by=fqav_by, device=dev)
        shards[p] = out[None]
    t_out, nif, nch = next(iter(shards.values())).shape[1:]
    part = MeshArray(mesh, "filterbank_sharded", (nband, t_out, nif, nbank * nch),
                     shards)
    if stitch:
        return stitch_despike(part, mesh=mesh, despike_nfpc=despike_nfpc,
                              timeline=timeline)
    if despike_nfpc >= 2:
        part.shards = {p: despike(t, despike_nfpc) for p, t in shards.items()}
    return part


def stitch_bands(x: MeshArray, mesh: Mesh, timeline=None) -> MeshArray:
    """Gather a bank-split filterbank into whole bands: the
    despike-free case of :func:`stitch_despike`."""
    return stitch_despike(x, mesh=mesh, despike_nfpc=0, timeline=timeline)


def stitch_despike(x: MeshArray, *, mesh: Mesh, despike_nfpc: int = 0,
                   timeline=None) -> MeshArray:
    """The stitch on its own: gather a bank-split filterbank ``(nband,
    t, nif, nchans)`` along the channel axis into the whole band, held by
    every local player of the row, and repair the DC spikes after it.

    Within a process the gather is a concatenation on the device of the
    row's first local player (peer copies from players on other
    devices); a row whose players span processes gathers through
    :func:`pod_gather` (every rank of the pod joins that call)."""
    shards = dict(x.shards)
    if mesh.spans_processes(BANK_AXIS):
        shards, _ = pod_gather(mesh, shards, timeline)
    nband, nbank = mesh.devices.shape
    out: Dict[Player, torch.Tensor] = {}
    for b in range(nband):
        mine = [p for p in sorted(x.shards) if p[0] == b]
        if not mine:
            continue
        dev = mesh.devices[mine[0]]
        row = torch.cat([shards[(b, k)].to(dev, non_blocking=True)
                         for k in range(nbank)], dim=3)
        if despike_nfpc >= 2:
            row = despike(row, despike_nfpc)
        copies = {dev: row}
        for p in mine:
            d = mesh.devices[p]
            if d not in copies:
                copies[d] = row.to(d, non_blocking=True)
            out[p] = copies[d]
    return MeshArray(mesh, "filterbank_stitched", x.shape, out)


def timed_stitch(x: MeshArray, *, mesh: Mesh, despike_nfpc: int,
                 timeline) -> Tuple[MeshArray, float]:
    """:func:`stitch_despike` with its inputs synchronized first, then
    timed to completion: the honest ``mesh.gather_s`` sample of a probe
    window."""
    x.synchronize()
    t0 = time.perf_counter()
    out = stitch_despike(x, mesh=mesh, despike_nfpc=despike_nfpc,
                         timeline=timeline)
    out.synchronize()
    return out, time.perf_counter() - t0


class ShardedAccumulator:
    """A windowed fold accumulator that carries its partition rule: the
    value (a :class:`MeshArray`, or a tuple of them), the mesh and the
    :data:`PARTITION_RULES` entry that splits it travel together, so
    every fold and the final read agree on placement.

    :meth:`init` installs the first window's value; :meth:`fold` runs
    ``value = fn(value, *args, **kw)`` (``fn`` may add in place) and
    checks that the result keeps the rule, so a drifted split fails at
    the first window."""

    def __init__(self, mesh: Mesh, rule: Union[str, PartitionSpec]):
        self.mesh = mesh
        self.rule = rule
        self.spec = partition_rule(rule)
        self.value = None

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    def init(self, value):
        self.value = value
        self._check(value)
        return value

    def fold(self, fn, *args, **kw):
        if self.value is None:
            raise RuntimeError("ShardedAccumulator.fold before init")
        self.value = fn(self.value, *args, **kw)
        self._check(self.value)
        return self.value

    def _check(self, value) -> None:
        leaves: Iterable = value if isinstance(value, (tuple, list)) else (value,)
        for leaf in leaves:
            got = getattr(leaf, "spec", None)
            if got is not None and (got != self.spec or leaf.mesh is not self.mesh):
                raise ValueError(f"accumulator sharding drifted from rule "
                                 f"{self.rule!r}: {got!r} != {self.spec!r}")
