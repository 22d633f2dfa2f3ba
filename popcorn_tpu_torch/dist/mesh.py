"""Rank layout and collectives.

Counterpart of popcorn_tpu/dist/mesh.py. The JAX package shards one
program over a device mesh and XLA inserts the collectives. Here every
rank is a process with one device, a ``Mesh`` is this rank's place in a
(data, ensemble) grid of ranks, and the collectives are explicit
``torch.distributed`` calls:

  * ``data``: data-parallel training (the batch's rows split over the
    ranks, gradients summed by one all-reduce), patch-split inference, and
    the row blocks of whole-frame inference (infer/spatial.py) and of
    spatial training (``shard_batch_spatial``, dist/rows.py);
  * ``ensemble``: Bag-of-POPCORN members split over the ranks, the
    minor axis (rank = data_index * n_ensemble + ensemble_index), as in
    the JAX mesh.

Tensor and pipeline parallelism are absent for the JAX package's reason:
the widest layer has 64 channels.

Backend: NCCL when every rank of a host has a card of its own; gloo for
CPU ranks and for ranks that share a card (the one-card rehearsal,
dist/multihost.py). The choice is made from the layout, logged, and
never replaced after a failure. Gloo runs most collectives on CPU tensors
only, so a CUDA tensor on a gloo group travels through host memory.

Ranks come from ``torchrun`` (``init_distributed`` reads its
environment) or from ``dist/launch.py::spawn_ranks``, which the CLIs use
for ``--data_parallel N``. Nothing here initialises a process group at
import, and every helper takes ``mesh=None`` as the single-device case.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .rows import rank_rows

Tree = Dict[str, Any]

# seconds a collective may wait for the other ranks before it fails the run
TIMEOUT_S = 900


def _world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_world(world: int) -> int:
    """Ranks on this host (torchrun's LOCAL_WORLD_SIZE; every rank when unset)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def resolve_device(device) -> torch.device:
    """The device an entry point or a rank runs on: CUDA unless the caller
    asks for the CPU. Asking for CUDA without a card raises; nothing drops
    to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def rank_devices(devices: Optional[Sequence] = None, world: Optional[int] = None) -> List[torch.device]:
    """The device of every rank, in rank order: ``devices`` as given (one a
    rank; it may repeat a card, which only the one-card rehearsal does),
    else each host's cards in order (rank r on card r mod ranks-a-host).
    A card asked for on a host without one raises RuntimeError
    (``resolve_device``); more ranks on a host than it has cards raise
    ValueError."""
    if world is None:
        world = _world()[1]
    if devices is not None:
        return [resolve_device(d) for d in devices]
    resolve_device("cuda")
    local, n_cards = _local_world(world), torch.cuda.device_count()
    if local > n_cards:
        raise ValueError(f"requested {local} devices, only {n_cards} available")
    return [torch.device("cuda", r % local) for r in range(world)]


def choose_backend(devs: Sequence[torch.device], local: Optional[int] = None) -> Tuple[str, str]:
    """(backend, reason) for ranks on ``devs``: NCCL when every rank of a
    host has a card of its own, else gloo."""
    devs = [torch.device(d) for d in devs]
    if not all(d.type == "cuda" for d in devs):
        return "gloo", "CPU ranks"
    local = local or len(devs)
    for h in range(0, len(devs), local):
        block = [d.index for d in devs[h:h + local]]
        if len(set(block)) != len(block):
            return "gloo", "ranks share a card (NCCL takes one rank a card)"
    return "nccl", "one card a rank"


def init_distributed(devices: Optional[Sequence] = None, backend: Optional[str] = None):
    """The counterpart of ``jax.distributed.initialize``: join the process
    group described by torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), with the
    backend chosen from the ranks' devices (``choose_backend``) unless
    ``backend`` names one. Returns (rank, world size); (0, 1) and no group
    when WORLD_SIZE is unset or 1."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 0, 1
    rank = int(os.environ["RANK"])
    devs = rank_devices(devices, world)
    reason = "asked for"
    if backend is None:
        backend, reason = choose_backend(devs, _local_world(world))
    if devs[rank].type == "cuda":
        torch.cuda.set_device(devs[rank])
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    print(f"[rank {rank}/{world}] torch.distributed backend {backend} ({reason}) "
          f"on {devs[rank]}", flush=True)
    return rank, world


_GROUPS: Dict[Tuple[int, int], Tuple[Any, Any]] = {}


def _axis_groups(nd: int, ne: int):
    """(data group, ensemble group) of this rank: every rank creates every
    group, in the same order (torch.distributed.new_group's contract)."""
    if (nd, ne) in _GROUPS:
        return _GROUPS[(nd, ne)]
    rank = dist.get_rank()
    data_g = ens_g = None
    if ne == 1:
        data_g = dist.group.WORLD
    else:
        for e in range(ne):
            g = dist.new_group([d * ne + e for d in range(nd)])
            if rank % ne == e:
                data_g = g
        for d in range(nd):
            g = dist.new_group([d * ne + e for e in range(ne)])
            if rank // ne == d:
                ens_g = g
    _GROUPS[(nd, ne)] = (data_g, ens_g)
    return data_g, ens_g


class Mesh:
    """This rank's place in an (n_data x n_ensemble) grid of ranks, its
    device and the process group of each axis."""

    def __init__(self, n_data: int, n_ensemble: int, rank: int, device,
                 backend: Optional[str] = None, data_group=None, ensemble_group=None):
        self.n_data, self.n_ensemble, self.rank = n_data, n_ensemble, rank
        self.device = torch.device(device)
        self.backend = backend
        self._groups = {"data": data_group, "ensemble": ensemble_group,
                        None: dist.group.WORLD if backend else None}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",) if self.n_ensemble == 1 else ("data", "ensemble")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, **({"ensemble": self.n_ensemble}
                                        if self.n_ensemble > 1 else {})}

    @property
    def size(self) -> int:
        return self.n_data * self.n_ensemble

    @property
    def data_index(self) -> int:
        return self.rank // self.n_ensemble

    @property
    def ensemble_index(self) -> int:
        return self.rank % self.n_ensemble

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def __repr__(self) -> str:
        return (f"Mesh(data={self.n_data}, ensemble={self.n_ensemble}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    def axis_size(self, axis: Optional[str]) -> int:
        return {"data": self.n_data, "ensemble": self.n_ensemble, None: self.size}[axis]

    # -- batch rows -----------------------------------------------------------

    def batch_rows(self, b: int, n_micro: int = 1) -> np.ndarray:
        """Indices of this rank's rows of a global batch of ``b``: its
        ``1/n_data`` of each of the ``n_micro`` microbatches, so that
        microbatch i of every rank together is the global microbatch i."""
        nd = self.n_data
        if b % (nd * n_micro):
            raise ValueError(f"a batch of {b} does not split into {n_micro} microbatches "
                             f"over {nd} data ranks (pad_batch_to_multiple)")
        mb = b // n_micro
        per = mb // nd
        start = self.data_index * per
        return (np.arange(n_micro)[:, None] * mb + start + np.arange(per)[None]).ravel()

    # -- collectives ------------------------------------------------------------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it: host memory for gloo, this
        rank's card for NCCL (the same tensor when it is there already)."""
        want = torch.device("cpu") if self.backend == "gloo" else self.device
        return t if t.device == want else t.to(want)

    def _run(self, op, t: torch.Tensor) -> torch.Tensor:
        """In-place collective ``op`` on ``t`` through ``_wire``."""
        c = self._wire(t)
        op(c)
        if c is not t:
            t.copy_(c)
        return t

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = None, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place sum (or ``op``) of ``t`` over ``axis`` (None: every rank)."""
        if self.axis_size(axis) == 1:
            return t
        return self._run(lambda c: dist.all_reduce(c, op=op, group=self._groups[axis]), t)

    def reduce_to_root(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over every rank, on rank 0 (in place; the other
        ranks' ``t`` are left unspecified)."""
        if self.size == 1:
            return t
        return self._run(lambda c: dist.reduce(c, dst=0), t)

    def all_gather(self, t: torch.Tensor, axis: Optional[str] = "data") -> torch.Tensor:
        """Concatenation over ``axis`` of every rank's ``t`` along dim 0,
        in the axis's rank order (equal shapes on every rank)."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        src = self._wire(t.detach().contiguous())
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._groups[axis])
        return torch.cat(parts).to(t.device)

    def gather_rows_with_grad(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """``all_gather`` whose result carries the gradient through this
        rank's own rows only: a loss of the global rows then gives this
        rank its share of the global gradient, and the shares sum to it."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        full = self.all_gather(t, axis)
        k = t.shape[0]
        i = self.data_index if axis == "data" else self.ensemble_index
        return torch.cat([full[: i * k], t, full[(i + 1) * k:]])

    def sum_with_grad(self, t: torch.Tensor, axis: Optional[str] = "data") -> torch.Tensor:
        """The sum of a scalar over ``axis`` whose gradient flows through
        this rank's term only."""
        if self.axis_size(axis) == 1:
            return t
        total = self.all_reduce(t.detach().clone(), axis)
        return t + (total - t.detach())

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In-place broadcast of rank ``src``'s ``t`` to every rank."""
        if self.size == 1:
            return t
        return self._run(lambda c: dist.broadcast(c, src=src), t)

    def broadcast_object(self, obj, src: int = 0):
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def all_true(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank."""
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        return bool(self.all_reduce(t, op=dist.ReduceOp.MIN).item())


def make_mesh(
    n_data: Optional[int] = None,
    devices: Optional[Sequence] = None,
    n_ensemble: int = 1,
) -> Mesh:
    """This rank's place in an (n_data x n_ensemble) grid of ranks
    (popcorn_tpu/dist/mesh.py::make_mesh). ``n_data`` defaults to every
    rank (divided by ``n_ensemble``). Raises ValueError, as JAX's does,
    when the grid asks for more devices than there are (two data ranks on
    a one-card host), RuntimeError when a card is asked for on a host
    without one (``rank_devices``), and ValueError when the process group does
    not hold exactly the grid's ranks: launch them with torchrun, or let
    the CLIs spawn them. A rank of a torchrun group joins it here
    (``init_distributed``) when it has not yet."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(devices)
    rank, world = _world()
    devs = rank_devices(devices, world)
    # the devices a grid may take (JAX's jax.devices()): those given, else
    # every card of each host
    n_avail = (len(devs) if devices is not None
               else max(1, world // _local_world(world)) * torch.cuda.device_count())
    if n_ensemble <= 1:
        nd, ne = n_data or world, 1
        if nd > n_avail:
            raise ValueError(f"requested {nd} devices, only {n_avail} available")
    else:
        nd, ne = n_data or max(1, world // n_ensemble), n_ensemble
        if nd * ne > n_avail:
            raise ValueError(
                f"requested {nd}x{ne} mesh, only {n_avail} devices available"
            )
    if nd * ne != world:
        raise ValueError(
            f"a {nd}x{ne} mesh needs {nd * ne} ranks, this process group has {world}: "
            f"launch {nd * ne} ranks (torchrun --nproc_per_node {nd * ne}, or the CLIs' "
            "--data_parallel/--ensemble_parallel, which spawn them)"
        )
    if world == 1:
        return Mesh(1, 1, 0, devs[0])
    data_g, ens_g = _axis_groups(nd, ne)
    return Mesh(nd, ne, rank, devs[rank], dist.get_backend(), data_g, ens_g)


def devices_for(device, n: Optional[int] = None) -> List[str]:
    """The ``devices`` of ``n`` ranks (default: this process group's) for
    an entry point's ``--device``: one CPU a rank for 'cpu'; the card named
    for one rank ('cuda:1' stays card 1); else one card a rank
    (``rank_devices``, which raises without enough cards)."""
    n = n or _world()[1]
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ["cpu"] * n
    if n == 1 and dev.index is not None:
        return [str(dev)]
    return [str(d) for d in rank_devices(None, n)]


def ensemble_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.n_ensemble


def make_multihost_mesh(n_data_per_host: Optional[int] = None, n_ensemble: int = 1,
                        devices: Optional[Sequence] = None) -> Mesh:
    """Multi-host grid (popcorn_tpu/dist/mesh.py::make_multihost_mesh):
    data-parallel over hosts times data/ensemble within each host. Ranks
    are numbered host-major (torchrun's order), so each host's ranks are
    contiguous on the 'data' axis and a gradient all-reduce sums within a
    host's block before it crosses the network. Under one host (one
    process, or every rank on this host) it is ``make_mesh``'s grid, so
    the CLI path is the same either way."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(devices)
    rank, world = _world()
    local = _local_world(world)
    hosts = max(1, world // local)
    nd = n_data_per_host or max(1, local // n_ensemble)
    if hosts == 1:
        return make_mesh(nd, devices=devices, n_ensemble=n_ensemble)
    if hosts * nd * n_ensemble > world:
        raise ValueError(f"need {hosts}x{nd}x{n_ensemble} ranks, have {world}")
    return make_mesh(hosts * nd, devices=devices, n_ensemble=n_ensemble)


def pad_batch_to_multiple(batch: Dict, multiple: int, batch_keys: Sequence[str]) -> Dict:
    """Pad the leading axis so it divides ``multiple`` (repeating the last
    row); adds or extends a 'valid' bool mask so padded rows weigh
    nothing downstream. Numpy arrays or tensors."""
    some = next(k for k in batch_keys if k in batch)
    b = batch[some].shape[0]
    rem = (-b) % multiple
    out = dict(batch)
    if rem == 0:
        if "valid" not in batch:
            out["valid"] = np.ones(b, bool)
        return out
    for k in batch_keys:
        if k in batch:
            v = batch[k]
            if isinstance(v, torch.Tensor):
                out[k] = torch.cat([v, v[-1:].expand(rem, *v.shape[1:])])
            else:
                out[k] = np.concatenate([v, np.repeat(v[-1:], rem, axis=0)], axis=0)
    valid = np.asarray(batch.get("valid", np.ones(b, bool)), bool)
    out["valid"] = np.concatenate([valid, np.zeros(rem, bool)])
    return out


def _take_rows(v, rows: np.ndarray):
    if isinstance(v, torch.Tensor):
        return v[torch.as_tensor(rows, device=v.device)]
    return np.asarray(v)[rows]


def shard_batch(batch: Dict, mesh: Optional[Mesh], *, batch_keys: Sequence[str],
                n_micro: int = 1) -> Dict:
    """This rank's rows of a global batch: ``batch_keys`` (and 'valid')
    taken at ``mesh.batch_rows``, the rest (per-batch values such as
    'photometric') as they are. Every rank holds the same global batch
    (the feeds are deterministic). A batch that the mesh-aware device feed
    already assembled as this rank's rows (it carries 'rows') passes
    through."""
    if mesh is None or mesh.n_data == 1 or "rows" in batch:
        return batch
    some = next(k for k in batch_keys if k in batch)
    rows = mesh.batch_rows(batch[some].shape[0], n_micro)
    keys = set(batch_keys) | {"valid"}
    return {k: (_take_rows(v, rows) if k in keys else v) for k, v in batch.items()}


def shard_batch_spatial(batch: Dict, mesh: Optional[Mesh], *, row_keys: Sequence[str]) -> Dict:
    """This rank's rows of a host batch for spatial training
    (popcorn_tpu/dist/mesh.py::shard_batch_spatial): each (B, H, W[, C])
    key of ``row_keys`` cut to the rows [u0, u1) that this rank reads (its
    kept rows [k0, k1) of dist/rows.py::rank_rows and their context), the
    other keys whole, and 'row_block' = (H, k0, k1, u0, u1), which the
    train step reads. Every rank passes the same global batch. With no
    mesh, or one data rank, the batch is returned as it is (the plain
    step)."""
    if mesh is None or mesh.n_data == 1:
        return batch
    cut = [k for k in row_keys if k in batch and getattr(batch[k], "ndim", 0) >= 3]
    rows = rank_rows(batch[cut[0]].shape[1], mesh)

    def take(v):
        v = v[:, rows.u0:rows.u1]
        return v.contiguous() if isinstance(v, torch.Tensor) else np.ascontiguousarray(v)

    out = {k: (take(v) if k in cut else v) for k, v in batch.items()}
    out["row_block"] = (rows.hp, rows.k0, rows.k1, rows.u0, rows.u1)
    return out


def device_put_global(v, mesh: Optional[Mesh] = None, device=None):
    """The global host value ``v`` (every rank passes the same one) as a
    tensor on this rank's device (without a mesh, ``device``: the card
    unless the caller asks for the CPU); trees map over their leaves.
    Tensors already there pass through."""
    dev = resolve_device(mesh.device if mesh is not None else device or "cuda")
    if isinstance(v, dict):
        return {k: device_put_global(a, mesh, dev) for k, a in v.items()}
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return torch.from_numpy(np.ascontiguousarray(v)).to(dev)


def fetch_to_host(x, mesh: Optional[Mesh] = None, axis: Optional[str] = "data"):
    """Numpy value of ``x``; under a mesh, the concatenation of every
    ``axis`` rank's rows (an all-gather, so every rank calls it on the same
    values in the same order). Trees map over their leaves."""
    if isinstance(x, dict):
        return {k: fetch_to_host(v, mesh, axis) for k, v in x.items()}
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if mesh is not None:
        x = mesh.all_gather(x.reshape(1) if x.dim() == 0 else x, axis)
    return x.detach().cpu().numpy()


def replicate(tree: Tree, mesh: Optional[Mesh]) -> Tree:
    """Every leaf broadcast from rank 0 (in sorted key order), so replicas
    start equal whatever each rank loaded."""
    if mesh is None or mesh.size == 1:
        return tree
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            replicate(v, mesh)
        elif isinstance(v, torch.Tensor):
            mesh.broadcast(v)
    return tree
