"""The (data, seq) mesh on ``torch.distributed``.

The reference package lays its devices out as a 2-D logical mesh:

* ``data`` — data parallelism over utterances/batches (rows of the batch);
* ``seq``  — sequence (time-axis) parallelism for long utterances, with a
  ``frame_len - hop`` halo exchanged between neighbours
  (:mod:`mfcc_rust_tpu_torch.parallel.halo`).

Here one process drives one device (one rank), every rank of the mesh runs
the same program (SPMD), and rank ``r`` of the mesh's group sits at
``(r // n_seq, r % n_seq)``.  Besides its world group the mesh holds a
**seq group** (the ranks of one data row, ordered by seq index) and a
**data group** (the ranks of one seq column).  A mesh built without an
initialized process group is the one-rank mesh: a real configuration, in
which every collective is the identity.

The shardings keep their reference names and say which block of a global
array this rank holds: ``P(DATA_AXIS)`` rows ``[d*B/n_data, (d+1)*B/n_data)``,
``P(DATA_AXIS, SEQ_AXIS)`` those rows and columns ``[s*T/n_seq, ...)``,
``P()`` the whole array.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def init_process_group(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: float = 60.0,
    device=None,
) -> Tuple[int, int]:
    """Join the process group (call once per process, before any mesh) and
    return (rank, world_size).  NCCL for a CUDA device, gloo for the CPU,
    unless ``backend`` says otherwise; ``timeout`` in seconds bounds every
    collective, so a lost peer fails instead of hanging.  With neither
    ``init_method`` nor ``world_size > 1`` no group is made: the process is
    the one-rank world.  Under ``torchrun`` pass ``init_method="env://"``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not init_method and not (world_size is not None and world_size > 1):
        return 0, 1
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout),
    )
    return dist.get_rank(), dist.get_world_size()


def _default_device(global_rank: int, device) -> torch.device:
    """``cuda:{LOCAL_RANK}`` (else rank modulo the device count) unless
    ``device`` says otherwise; raises without CUDA unless asked for the
    CPU."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)  # raises without CUDA
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else global_rank % torch.cuda.device_count()
    return torch.device("cuda", idx)


class Mesh:
    """A (data, seq) layout of the ranks of one process group.

    ``shape`` maps each axis name to its size; ``coords`` is this rank's
    (data, seq) position; ``devices`` the (n_data, n_seq) array of global
    ranks.  ``group`` is None for the one-rank mesh."""

    def __init__(self, n_data: int, n_seq: int, group, device: torch.device):
        self.shape = {DATA_AXIS: n_data, SEQ_AXIS: n_seq}
        self.axis_names = (DATA_AXIS, SEQ_AXIS)
        self.group = group
        self.device = device
        self.size = n_data * n_seq
        if group is None:
            self.rank, ranks = 0, [dist.get_rank() if dist.is_initialized() else 0]
        else:
            self.rank = dist.get_rank(group)
            ranks = [dist.get_global_rank(group, i) for i in range(self.size)]
        self.devices = np.asarray(ranks).reshape(n_data, n_seq)
        self.coords = (self.rank // n_seq, self.rank % n_seq)
        d, s = self.coords
        self.seq_ranks = [int(r) for r in self.devices[d]]
        self.data_ranks = [int(r) for r in self.devices[:, s]]
        self.seq_group = self._subgroup([list(map(int, row)) for row in self.devices],
                                        self.seq_ranks)
        self.data_group = self._subgroup([list(map(int, c)) for c in self.devices.T],
                                         self.data_ranks)

    def _subgroup(self, all_ranks, mine):
        """The process group of ``mine`` (one row or column of the mesh):
        the mesh's own group when it spans the mesh, None for one rank (its
        collectives are identities), else a new group.  A mesh over the
        whole world makes every row's (column's) group in order on every
        rank, as ``new_group`` asks; a mesh over part of the world makes
        only its own, with local synchronization."""
        if self.group is None or len(mine) == 1:
            return None
        if len(mine) == self.size:
            return self.group
        if dist.get_world_size() == self.size:
            out = None
            for ranks in all_ranks:
                g = dist.new_group(ranks)
                if ranks == mine:
                    out = g
            return out
        return dist.new_group(mine, use_local_synchronization=True)

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over every rank of the mesh (in place; returns x)."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
        return x

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, seq={self.shape[SEQ_AXIS]}, "
                f"rank={self.rank}, coords={self.coords}, device={self.device})")


def make_mesh(
    n_data: Optional[int] = None,
    n_seq: int = 1,
    group=None,
    device=None,
) -> Mesh:
    """Build a (data, seq) mesh over ``group`` (default: the world when a
    process group is initialized, else the one-rank mesh).  Defaults to all
    ranks on the data axis.  Every rank of the group must call this, in the
    same order as its other collectives."""
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    size = dist.get_world_size(group) if group is not None else 1
    if n_data is None:
        n_data = size // n_seq
    if n_data * n_seq != size:
        raise ValueError(
            f"mesh {n_data} x {n_seq} does not cover the group's {size} ranks"
        )
    global_rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(n_data, n_seq, group, _default_device(global_rank, device))


def P(*axes) -> Tuple:
    """A partition spec: the mesh axis (or None) of each leading dim."""
    return tuple(axes)


class NamedSharding:
    """Which block of a global array this rank of ``mesh`` holds."""

    def __init__(self, mesh: Mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = tuple(spec)

    def block(self, x):
        """This rank's block of the global array x (a view or a slice)."""
        idx = []
        for dim, name in enumerate(self.spec):
            if name is None:
                idx.append(slice(None))
                continue
            n = self.mesh.shape[name]
            pos = self.mesh.coords[0 if name == DATA_AXIS else 1]
            length = x.shape[dim]
            if length % n:
                raise ValueError(f"dim {dim} of length {length} not divisible by {name} axis {n}")
            step = length // n
            idx.append(slice(pos * step, (pos + 1) * step))
        return x[tuple(idx)]


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch axis sharded over data, everything else replicated."""
    return NamedSharding(mesh, P(DATA_AXIS))


def data_seq_sharding(mesh: Mesh) -> NamedSharding:
    """(batch, time) sharded over (data, seq)."""
    return NamedSharding(mesh, P(DATA_AXIS, SEQ_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
