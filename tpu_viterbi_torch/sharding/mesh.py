"""The ranks of the multi-rank split and the collectives between them, over
``torch.distributed``; the counterpart of ``tpu_viterbi/sharding/mesh.py``.

The JAX package shards time-blocks of the coded stream over a 1-D device
mesh whose one axis is named ``'blocks'``; its devices exchange one
64-stage halo by ``ppermute``.  Here the "mesh" is a small object,
``BlockMesh``: this process' rank, the world size, the device it decodes
on and the process group (the one axis, so it needs no name), and ranks
exchange the same halo with point-to-point sends.
Every collective of the split goes through ``BlockMesh.collective``, which
records (op, dtype, element count) in ``BlockMesh.census``: that record is
what ``sharding/audit.py`` reads, where the JAX package reads optimised HLO.

Backend rule (``backend_for``), which picks the collective library and
never where the decode runs:

  - ``nccl`` when every rank has a card of its own (the ranks on a host are
    no more than its cards, each rank on ``cuda:LOCAL_RANK``);
  - ``gloo`` when the device is the CPU (the tests), or when ranks share a
    card (two ranks on one H100: each still decodes on the card, and only
    the halo words, the reference word and the scalar error count are
    staged through the host, since gloo's send and receive take CPU
    tensors).

A rank asked for ``cuda`` without a card raises, through
``hardware.resolve_device``: there is no fallback to the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..hardware import resolve_device

def backend_for(device: torch.device, local_world_size: int) -> str:
    """The collective library of the split: 'nccl' when every rank of a
    host has a card of its own, 'gloo' on the CPU or when ranks share a
    card."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() \
        else "gloo"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> Optional[str]:
    """Join the process group of the split (the counterpart of
    ``jax.distributed.initialize``): the coordinator ``host:port``, the
    number of processes and this one's id, each taken from the arguments or
    else from the usual variables ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` (as ``torchrun`` sets them).  With none of
    them given it is a no-op and returns None, as the JAX package's is at
    one process; an initialised group is left as it is.

    The backend is ``backend_for``'s (``nccl`` when every rank has a card
    of its own, ``gloo`` on the CPU or when ranks share a card;
    ``LOCAL_WORLD_SIZE`` says how many ranks share this host, all of them
    when unset).  Returns the backend in use.  ``device`` is resolved
    first: 'cuda' without a card raises."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_backend()
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if coordinator_address is None and "MASTER_ADDR" in os.environ \
            and "MASTER_PORT" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if coordinator_address is None and num_processes is None:
        return None
    if coordinator_address is None or num_processes is None:
        raise ValueError("initialize_distributed needs both the "
                         "coordinator address and the number of processes "
                         "(or MASTER_ADDR/MASTER_PORT and WORLD_SIZE)")
    if process_id is None:
        process_id = _env_int("RANK")
    if process_id is None:
        raise ValueError("initialize_distributed needs this process' id "
                         "(process_id, or RANK)")
    local = _env_int("LOCAL_WORLD_SIZE") or num_processes
    backend = backend_for(dev, local)
    if backend == "nccl":
        torch.cuda.set_device(local_device(dev, process_id, local))
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return backend


def local_device(device: torch.device, rank: int,
                 local_world_size: int) -> torch.device:
    """The device a rank decodes on: the CPU as given; on the card
    ``cuda:LOCAL_RANK`` when every rank of the host has a card of its own,
    else the card given (ranks sharing it)."""
    if device.type != "cuda" or device.index is not None:
        return device
    if local_world_size <= torch.cuda.device_count():
        local_rank = _env_int("LOCAL_RANK")
        return torch.device("cuda", rank % local_world_size
                            if local_rank is None else local_rank)
    return torch.device("cuda", 0)


@dataclass
class BlockMesh:
    """The split's ranks as this process sees them: its ``rank`` of
    ``size``, the ``device`` it decodes on, the process ``group`` (None
    when no process group is initialised: one rank, or ``size`` ranks
    held in one process, which issue no collective) and its
    ``backend``.  ``census`` records each collective issued through
    ``collective``.  What a collective returns lies on ``device``."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None
    backend: Optional[str] = None
    census: List[Tuple[str, str, int]] = field(default_factory=list)

    def collective(self, op: str, tensor: torch.Tensor) -> None:
        """Record one collective of the split: (op, dtype, elements a
        rank).  Raises where no process group would carry it."""
        if self.group is None:
            raise RuntimeError(f"{op} over {self.size} ranks needs a "
                               f"process group (initialize_distributed)")
        self.census.append((op, str(tensor.dtype).replace("torch.", ""),
                            tensor.numel()))

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor as the backend takes it: gloo's point-to-point and
        gather take CPU tensors, so CUDA ones go through the host; nccl
        takes tensors on this rank's card only, so a host one (the CLI's
        seed) goes there."""
        return t.cpu() if self.backend == "gloo" else t.to(self.device)

    def shift_left(self, t: torch.Tensor) -> torch.Tensor:
        """Rank d receives ``t`` of rank (d + 1) mod size: the cyclic
        ``perm`` of ``ppermute`` (blocks.py:101).  One send and one receive
        a rank in one ``batch_isend_irecv``; at one rank the identity,
        with no collective (JAX's ppermute over one device; NCCL may not
        accept a send to self)."""
        t = t.contiguous()
        if self.size == 1:
            return t
        self.collective("permute", t)
        src = self._staged(t)
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, (self.rank - 1) % self.size,
                          self.group),
               dist.P2POp(dist.irecv, out, (self.rank + 1) % self.size,
                          self.group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return out.to(self.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a scalar count); with no group
        (one rank, no process) ``t`` itself."""
        if self.group is None and self.size == 1:
            return t
        self.collective("all_reduce", t)
        x = self._staged(t).clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x.to(self.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (the CLI's seed); at one rank
        ``t``."""
        if self.size == 1:
            return t
        self.collective("broadcast", t)
        x = self._staged(t).clone()
        dist.broadcast(x, src, group=self.group)
        return x.to(self.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's equal-sized ``t``, concatenated in rank order, on
        every rank (``process_allgather(tiled=True)``); at one rank ``t``."""
        if self.size == 1:
            return t
        self.collective("all_gather", t)
        src = self._staged(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(self.device)


def make_block_mesh(device="cuda") -> BlockMesh:
    """The split over every rank of the initialised process group (the
    counterpart of the JAX package's 1-D 'blocks' mesh over all devices),
    or one rank when none is.  ``device``: where this rank decodes, the
    card unless the caller asks for the CPU ('cuda' without a card
    raises); on the card each rank takes ``local_device``'s."""
    dev = resolve_device(device)
    if dist.is_initialized():
        rank, n = dist.get_rank(), dist.get_world_size()
        local = _env_int("LOCAL_WORLD_SIZE") or n
        return BlockMesh(rank, n, local_device(dev, rank, local),
                         dist.group.WORLD, dist.get_backend())
    return BlockMesh(0, 1, dev)
