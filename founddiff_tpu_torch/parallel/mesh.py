"""The ('data', 'seq') process mesh and its helpers (mirror of
``founddiff_tpu/parallel/mesh.py``).

The reference's only distribution strategy is torch-DDP data parallelism
through HF Accelerate over NCCL (reference src/DADiff.py:1546-1552,
1617-1622).  The JAX package lays its devices out as a ('data', 'seq')
mesh: the batch sharded over 'data', parameters replicated, and a 'seq'
axis for the sequence-sharded selective scan of full-volume inference.
Here the mesh is one process per card (``torchrun``), laid out as
``np.arange(world).reshape(data, seq)`` as the JAX mesh lays out its
devices, so a seq group is consecutive ranks.  Each rank holds a process
group over its data column and one over its seq row; the collectives are
explicit (``torch.distributed``): the trainer's gradient all-reduce over
'data', the scan's all-gathers over 'seq', the volume's over 'data'.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

class Mesh:
    """This rank's view of a ``data x seq`` layout of the ranks.

    ``shape`` ``{'data': n, 'seq': m}`` and ``axis_names`` as the JAX mesh
    has them; ``ranks`` the ``[data, seq]`` array of global ranks;
    ``index[axis]`` this rank's coordinate; ``groups[axis]`` the process
    group of the ranks that differ from this one along ``axis`` only (None
    without a process group: one process, mesh ``(1, 1)``)."""

    axis_names = ("data", "seq")

    def __init__(self, data: int, seq: int, rank: int = 0):
        self.shape = {"data": data, "seq": seq}
        self.ranks = np.arange(data * seq).reshape(data, seq)
        i, j = np.argwhere(self.ranks == rank)[0]
        self.index = {"data": int(i), "seq": int(j)}
        self.groups = {"data": None, "seq": None}

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n``, split evenly over the data axis."""
        k = self.shape["data"]
        if n % k:
            raise ValueError(f"{n} rows do not split over the data axis of {k} ranks")
        m = n // k
        return slice(self.index["data"] * m, (self.index["data"] + 1) * m)

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``[k * t.shape[0], ...]``: every rank's ``t`` along ``axis`` in
        rank order, concatenated over dim 0 (one ``all_gather_into_tensor``;
        ``t`` itself where the axis has one rank and no group)."""
        group = self.groups[axis]
        if group is None:
            return t
        t = t.contiguous()
        out = t.new_empty((self.shape[axis] * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
        return out


def make_mesh(data: Optional[int] = None, seq: int = 1) -> Mesh:
    """The ('data', 'seq') mesh of the ranks of the default process group
    (one process without one).  ``data=None`` puts every rank on the data
    axis, divided by ``seq``.  With a process group, every rank must call
    this, in the same order: the groups are made with ``dist.new_group``
    on every rank, also those of one rank, so that a world of one runs the
    same collectives."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data is None:
        if world % seq:
            raise ValueError(f"{world} ranks do not split into seq groups of {seq}")
        data = world // seq
    if data * seq != world:
        raise ValueError(f"mesh {data}x{seq} != {world} ranks")
    mesh = Mesh(data, seq, rank)
    if dist.is_initialized():
        for axis, lines in (("data", mesh.ranks.T), ("seq", mesh.ranks)):
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    mesh.groups[axis] = group
    return mesh


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (a tensor, an array, or a tuple or
    list of them), its leading axis split over 'data' as the JAX
    ``shard_batch`` places it."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    return batch[mesh.rows(batch.shape[0])]


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, torch.optim.Optimizer):
        for state in obj.state.values():
            yield from (v for v in state.values() if torch.is_tensor(v))
    else:
        for o in obj:
            yield from _tensors(o)


@torch.no_grad()
def replicate_state(*objs) -> None:
    """Rank 0's parameters, buffers, optimizer state and tensors broadcast
    in place to every rank (modules, optimizers, tensors or iterables of
    them); a no-op without a process group."""
    if not dist.is_initialized():
        return
    for t in _tensors(objs):
        dist.broadcast(t.data, src=0)


def init_distributed(device="cuda", *, rank: Optional[int] = None,
                     world_size: Optional[int] = None, store=None) -> torch.device:
    """The rendezvous of one process per card (the counterpart of the JAX
    ``jax.distributed.initialize``).  Reads torchrun's ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``
    (or takes ``rank``, ``world_size`` and a ``store``); without them it is
    a no-op.  On the card it takes ``cuda:LOCAL_RANK`` and NCCL, with no
    fallback; gloo only when the caller passes the CPU.  Returns this
    rank's device."""
    device = torch.device(device)
    rank = int(os.environ["RANK"]) if rank is None and "RANK" in os.environ else rank
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None or world_size is None or dist.is_initialized():
        return device
    if device.type == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA card for NCCL; pass device='cpu' "
                               "for gloo on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", device.index or 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    kw = {"store": store} if store is not None else {"init_method": "env://"}
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    return device
