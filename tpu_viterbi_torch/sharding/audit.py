"""The collective census of the split: proof, without several cards, that
the sharded decode and simulation scale linearly in ranks (the counterpart
of ``tpu_viterbi/sharding/audit.py``).  The only traffic between ranks is

  - one halo exchange a rank: the first ``halo_words`` words of the right
    neighbour (32 at SOFT8; ``blocks.ShardedDecoder.__call__``),
  - one scalar all-reduce a simulate call (the error count), and
  - the O(1) reference realignment: one bit pack from the right neighbour
    (``simulate.ShardedSimulation.__call__``),

and nothing whose size grows with the shard or the rank count.  The JAX
package reads the collectives out of optimised HLO; the port has no HLO,
so it counts what it issues: every collective goes through
``BlockMesh.collective``, which records (op, dtype, elements a rank).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from ..config import ChannelIn, DecoderConfig
from .blocks import build_sharded_decoder, halo_words
from .mesh import BlockMesh

Census = List[Tuple[str, str, int]]


def collective_census(mesh: BlockMesh, fn: Callable, *args) -> Census:
    """The collectives this rank issues in one call ``fn(*args)``, in
    order, as (op, dtype, elements)."""
    mesh.census.clear()
    fn(*args)
    return list(mesh.census)


def audit_decoder(cfg: DecoderConfig, stages_per_device: int,
                  mesh: BlockMesh, dec_len=512) -> Census:
    """Census of one call of the sharded decoder
    (``blocks.build_sharded_decoder``) on zero words."""
    dec, _, local_words, _ = build_sharded_decoder(cfg, stages_per_device,
                                                   mesh, dec_len)
    dtype = torch.float32 if cfg.channel_in == ChannelIn.FP32 \
        else torch.int32
    words = torch.zeros(local_words, dtype=dtype, device=mesh.device)
    return collective_census(mesh, dec, words)


def audit_simulation(cfg: DecoderConfig, message_len: int, mesh: BlockMesh,
                     dec_len=512) -> Census:
    """Census of one call of the sharded simulation
    (``simulate.build_sharded_simulation`` with ``mesh``, generator
    'cuda': K7/K8 at each rank's base offset)."""
    from .simulate import build_sharded_simulation
    fn, _ = build_sharded_simulation(cfg, message_len, dec_len=dec_len,
                                     generator="cuda", mesh=mesh)
    return collective_census(mesh, fn, 0)


def expected_census(cfg: DecoderConfig, simulate: bool) -> Census:
    """The census the split must issue at every rank count above one: the
    halo exchange, and for a simulate call the realignment's one bit pack
    and the count's all-reduce."""
    wire = "float32" if cfg.channel_in == ChannelIn.FP32 else "int32"
    out = [("permute", wire, halo_words(cfg))]
    if simulate:
        out += [("permute", "int32", 1), ("all_reduce", "int64", 1)]
    return out
