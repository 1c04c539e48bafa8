"""The multi-process axis of the port (PyTorch port of sgrt_tpu.parallel.mesh).

One process per rank, joined in a torch.distributed process group: NCCL
for ranks on CUDA cards (one card a rank), gloo for ranks on the CPU. The
scene is replicated on every rank; rays or tiles are split by rank; the
train steps all-reduce the gradients once a step.

    initialize_distributed(...)   start the group (a no-op for one process)
    make_mesh()                   a Mesh over the running group, or over this
                                  process alone when there is no group
    shard_rays(mesh, *arrays)     this rank's contiguous slice of axis 0
    replicate(mesh, scene)        every field broadcast from rank 0

The mesh's collectives move one flat buffer a call. Only broadcast and
all_reduce are used, since gloo offers no other collective on CUDA tensors:
a mean is a SUM all-reduce divided by the mesh size (gloo has no AVG), and
gathering rows is a SUM all-reduce of a zero-filled buffer in which each
rank has written its own rows (adding zeros is exact).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from sgrt_tpu_torch.utils.device import resolve_device

RAYS_AXIS = "rays"   # the JAX package's mesh axis; the port's mesh has one axis


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, *, device="cuda",
                           backend: str | None = None) -> None:
    """Start the process group when there is more than one process.

    coordinator "host:port" is rank 0's TCP store; without it the group
    reads MASTER_ADDR/MASTER_PORT from the environment (env://, as torchrun
    sets them), and num_processes/process_id default to WORLD_SIZE/RANK.
    backend None means NCCL for a CUDA device and gloo for the CPU. Before
    the group starts, a CUDA rank selects card LOCAL_RANK (else
    process_id) modulo the card count. A backend that fails to start
    raises; nothing falls back to another backend."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    init = f"tcp://{coordinator}" if coordinator else "env://"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of `size` ranks: this process is `rank`, its tensors live
    on `device`. group None is a mesh of one rank without a process group,
    whose collectives are the identity."""

    group: object | None
    rank: int
    size: int
    device: torch.device

    def shard(self, n: int) -> slice:
        """This rank's contiguous slice of n items; raises ValueError when
        the mesh size does not divide n."""
        if n % self.size:
            raise ValueError(f"{n} is not divisible by the mesh ({self.size} ranks)")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def _flat(self, tensors) -> torch.Tensor:
        """A new 1-D buffer holding the tensors one after another."""
        return torch.cat([t.detach().reshape(-1) for t in tensors])

    def _unflat(self, flat: torch.Tensor, like) -> list[torch.Tensor]:
        sizes = [t.numel() for t in like]
        return [v.view(t.shape) for v, t in zip(torch.split(flat, sizes), like)]

    def all_reduce(self, tensors, *, mean: bool = False) -> list[torch.Tensor]:
        """The sum (mean=True: the mean) of each tensor over the ranks, by
        one all-reduce of one flat buffer. The tensors share a dtype; the
        results are equal bit for bit on every rank (on a mesh without a
        group, the tensors themselves)."""
        if self.group is None:
            return list(tensors)
        flat = self._flat(tensors)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        if mean:
            flat = flat / self.size
        return self._unflat(flat, tensors)

    def broadcast(self, tensors) -> list[torch.Tensor]:
        """Rank 0's values of the tensors (one flat buffer) on every rank
        (on a mesh without a group, the tensors themselves)."""
        if self.group is None:
            return list(tensors)
        flat = self._flat(tensors)
        dist.broadcast(flat, src=dist.get_global_rank(self.group, 0), group=self.group)
        return self._unflat(flat, tensors)

    def gather_rows(self, local: torch.Tensor, rows, n: int) -> torch.Tensor:
        """An (n, ...) tensor on every rank, in which each rank's `local`
        rows stand at its `rows` (a slice or an index tensor) and every
        other row is zero before the SUM all-reduce adds the ranks'."""
        full = local.new_zeros((n,) + tuple(local.shape[1:]))
        full[rows] = local
        return self.all_reduce([full])[0]

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def make_mesh(device="cuda") -> Mesh:
    """A mesh over the running process group (this process's rank, the
    group's size, the card that initialize_distributed selected), or over
    this process alone when no group runs: one rank, collectives the
    identity (JAX's make_mesh over its one local device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return Mesh(None, 0, 1, dev)
    group = dist.group.WORLD
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev)


def shard_rays(mesh: Mesh, *arrays):
    """This rank's contiguous slice of each array's leading (ray) axis;
    ValueError when the mesh size does not divide it."""
    out = tuple(a[mesh.shard(a.shape[0])] for a in arrays)
    return out[0] if len(out) == 1 else out


def replicate(mesh: Mesh, tree):
    """A tensor, or a scene dataclass (GaussianScene, AnisoScene) field by
    field, with rank 0's values on every rank (one broadcast)."""
    if isinstance(tree, torch.Tensor):
        return mesh.broadcast([tree])[0]
    names = [f.name for f in dataclasses.fields(tree)]
    vals = mesh.broadcast([getattr(tree, n) for n in names])
    return type(tree)(**dict(zip(names, vals)))
