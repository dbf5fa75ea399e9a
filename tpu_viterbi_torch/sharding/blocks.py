"""Multi-rank block-parallel decode: overlap-save over the ranks of a
``BlockMesh``; the counterpart of ``tpu_viterbi/sharding/blocks.py``.

The coded stage stream is cut into one shard a rank; each rank decodes
exactly the output bits whose stages lie in its shard, and takes the
64-stage right halo, the first ``halo_words`` words of rank (d + 1) mod N,
in one exchange (``BlockMesh.shift_left``, JAX's cyclic ``ppermute``).
Overlap-save blocks are independent, so nothing else crosses ranks.

Integer channels decode the shard where it lies: K1 (K3 with the window)
reads the received halo as its ``tail_halo`` (``Source.p1``), so the shard
is never copied, at every shard size (the TPU needs its lane-tile
alignment for that, ``zero_copy_align_stages``; the sizes keep it so the
block framing stays JAX's).  FP32 concatenates [local, halo], as JAX's
non-aligned branch does (its staging pad is not needed: K2 zero-fills past
the stream), and decodes with K2 or K3.

The per-rank decode (``ShardedDecoder.local``) is a plain function of the
rank's words and the halo it received; the tests hold every rank of an
N-rank decode in one process through it (``decode_all_ranks``), and real
processes test only the wiring.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import ChannelIn, ConfigResolutionError, DecoderConfig
from ..decoder.api import BACKENDS
from ..decoder.core_cuda import (SURVIVORS, check_smem, decode_packed_cuda,
                                 resolve_window)
from ..decoder.core_torch import (WARMUP, auto_dec_len, decode_packed_torch,
                                  plan_blocks)
from ..hardware import resolve_device
from .mesh import BlockMesh

# The TPU's blocks a kernel program (core_pallas.py:71), kept as a constant
# of the port only because JAX's shard sizes are built on it
# (zero_copy_align_stages): block boundaries sit at rank * sd + k * dec_len,
# so the shard size decides the framing, and the decode differs under
# noise unless sd is JAX's.
LANE_TILE = 128


def sharded_stage_count(total_stages: int, num_ranks: int,
                        bits_per_pack: int, align: int = 0,
                        max_pad_num: int = 32) -> int:
    """Stages a rank: the total padded up so each shard is a whole number
    of packs and of packed input words for every channel (lcm 32), and
    rounded up to ``align`` where the global padding stays under
    total / max_pad_num (blocks.py:31-47, the same numbers)."""
    del bits_per_pack                  # JAX's signature; lcm 32 covers it
    per = -(-total_stages // num_ranks)
    per = -(-per // 32) * 32
    if align:
        per_a = -(-per // align) * align
        if per_a * num_ranks <= total_stages + total_stages // max_pad_num:
            per = per_a
    return per


def zero_copy_align_stages(cfg: DecoderConfig, dec_len: int) -> int:
    """JAX's shard alignment (blocks.py:50-63): LANE_TILE blocks of the
    bpp-trimmed dec_len.  The GPU decodes any shard in place; the multiple
    is kept so that decode_sharded's and the simulation's shard sizes, and
    so their block framing, are JAX's."""
    bpp = cfg.bits_per_pack
    return LANE_TILE * max(bpp, dec_len - dec_len % bpp)


def halo_words(cfg: DecoderConfig) -> int:
    """Words of the 64-stage halo a rank takes from its right neighbour
    (FP32: values)."""
    dpp = 1 if cfg.channel_in == ChannelIn.FP32 else cfg.enc_data_per_pack
    return 2 * WARMUP // dpp


class ShardedDecoder:
    """One rank's decode of its shard of ``stages_per_rank`` coded stages
    (``build_sharded_decoder``): ``local(words, halo)`` is the plain
    per-rank function, ``__call__(words)`` takes the halo from the right
    neighbour first."""

    def __init__(self, cfg: DecoderConfig, stages_per_rank: int,
                 mesh: BlockMesh, dec_len=2048, survivor: str = "auto",
                 backend: str = "auto"):
        sd = stages_per_rank
        if sd % 32:
            raise ValueError("stages_per_device must be a multiple of 32")
        if dec_len == "auto":        # the shard's own fill (auto_dec_len)
            dec_len = auto_dec_len(sd, cfg.bits_per_pack)
        if survivor not in SURVIVORS:
            raise ValueError(f"survivor must be 'auto', 'full' or 'window', "
                             f"got {survivor!r}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be 'auto', 'cuda' or 'torch', "
                             f"got {backend!r}")
        if backend == "cuda" and mesh.device.type != "cuda":
            raise ConfigResolutionError(
                f"backend='cuda' needs a CUDA device (device="
                f"{str(mesh.device)!r})")
        self.cfg, self.mesh, self.sd = cfg, mesh, sd
        self.plan = plan_blocks(sd, cfg.bits_per_pack, dec_len)
        self.window = resolve_window(survivor, cfg, self.plan, mesh.device)
        self.use_kernel = mesh.device.type == "cuda" and backend != "torch"
        if self.window and self.use_kernel:
            check_smem(cfg)            # a ring that cannot launch: refused now
        dpp = 1 if cfg.channel_in == ChannelIn.FP32 \
            else cfg.enc_data_per_pack
        self.local_words = sd * 2 // dpp
        self.halo_words = halo_words(cfg)
        # the integer channels take the halo in place (K1's/K3's tail_halo)
        # wherever the halo lies within the last block's neighbour
        self.in_place = cfg.channel_in != ChannelIn.FP32 \
            and self.plan.dec_len >= WARMUP
        self.info = {"backend": "cuda" if self.use_kernel else "torch",
                     "aligned": self.in_place, "window": self.window}

    def local(self, words: torch.Tensor, halo: torch.Tensor
              ) -> torch.Tensor:
        """The rank's decode: its ``local_words`` words and the first
        ``halo_words`` words of its right neighbour -> the flat int32
        packed output words of its sd stages (sd / bpp words)."""
        if words.shape[0] != self.local_words \
                or halo.shape[0] != self.halo_words:
            raise ValueError(f"a rank decodes {self.local_words} words and "
                             f"a {self.halo_words}-word halo, got "
                             f"{words.shape[0]} and {halo.shape[0]}")
        decode = decode_packed_cuda if self.use_kernel \
            else decode_packed_torch
        if self.in_place:
            return decode(words, self.cfg, self.plan, window=self.window,
                          tail_halo=halo)
        return decode(torch.cat([words, halo]), self.cfg, self.plan,
                      window=self.window)

    def __call__(self, words: torch.Tensor) -> torch.Tensor:
        """This rank's decode over the mesh: the halo from rank (d + 1) mod
        N (at one rank the shard's own first words), then ``local``."""
        halo = self.mesh.shift_left(words[: self.halo_words])
        return self.local(words, halo)


def build_sharded_decoder(cfg: DecoderConfig, stages_per_device: int,
                          mesh: BlockMesh, dec_len=2048,
                          survivor: str = "auto", backend: str = "auto"):
    """-> (decode, plan, local_words, info) for a shard of
    ``stages_per_device`` coded stages a rank, as the JAX builder returns
    them: ``decode(words)`` (a ShardedDecoder) decodes this rank's
    ``local_words`` words into its sd output bits; the globally valid
    prefix is get_message_len(2 * total stages) bits, and the last rank's
    tail past it (which read rank 0's head as its halo) is discarded by the
    caller.

    backend: ViterbiGPU's 'auto' | 'cuda' | 'torch'; survivor: 'auto' |
    'full' | 'window' (``core_cuda.resolve_window``; a window ring that does
    not fit shared memory is refused here).  info: {'backend', 'aligned'
    (the shard decoded in place, the halo read as K1's/K3's tail_halo),
    'window'}."""
    dec = ShardedDecoder(cfg, stages_per_device, mesh, dec_len, survivor,
                         backend)
    return dec, dec.plan, dec.local_words, dec.info


def shard_stages(cfg: DecoderConfig, input_num: int, num_ranks: int,
                 dec_len=2048):
    """(stages a rank, dec_len) of decode_sharded: 'auto' resolved against
    the unaligned shard size, then the shard aligned as JAX aligns it
    (blocks.py:199-207)."""
    total_stages = input_num // 2
    bpp = cfg.bits_per_pack
    if dec_len == "auto":
        dec_len = auto_dec_len(
            sharded_stage_count(total_stages, num_ranks, bpp), bpp)
    sd = sharded_stage_count(total_stages, num_ranks, bpp,
                             align=zero_copy_align_stages(cfg, dec_len))
    return sd, dec_len


def rank_words(packed_global, cfg: DecoderConfig, rank: int,
               local_words: int, device) -> torch.Tensor:
    """Rank ``rank``'s shard of the global packed stream on ``device``: its
    ``local_words`` words, zero past the stream's end (the natural-framing
    fill)."""
    dtype = np.float32 if cfg.channel_in == ChannelIn.FP32 else np.int32
    arr = packed_global
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    lo = rank * local_words
    part = np.asarray(arr[lo: lo + local_words]).astype(dtype)
    out = np.zeros(local_words, dtype)
    out[: part.shape[0]] = part
    return torch.from_numpy(out).to(device)


def _to_host(out: torch.Tensor, cfg: DecoderConfig) -> np.ndarray:
    words = out.cpu().numpy()
    return words.astype(np.uint16) if cfg.bits_per_pack == 16 \
        else words.view(np.uint32)


def run_sharded(cfg: DecoderConfig, sd: int, mesh: BlockMesh, dec_len,
                packed, backend: str = "auto", survivor: str = "auto"):
    """This rank's part of one sharded decode of the global ``packed``
    stream (host array or tensor) at ``sd`` stages a rank: its shard
    (``rank_words``: zero words past the stream, the natural-framing fill)
    and its neighbour's halo.  Returns (this rank's output words, a tensor
    on its device; info; the decoder; this rank's input words), so that a
    caller can decode again for timing; ``decode_sharded`` gathers the
    first over the ranks.  ``sharding.certify`` certifies the decode
    through it (the JAX package's ``certify.run_sharded``)."""
    dec, _plan, local_words, info = build_sharded_decoder(
        cfg, sd, mesh, dec_len, survivor=survivor, backend=backend)
    x = rank_words(packed, cfg, mesh.rank, local_words, mesh.device)
    return dec(x), info, dec, x


def decode_sharded(packed_global, input_num: int, cfg: DecoderConfig,
                   mesh: BlockMesh, dec_len=2048, survivor: str = "auto",
                   backend: str = "auto") -> Tuple[np.ndarray, int]:
    """End-to-end sharded decode over ``mesh``: every rank takes its shard
    of the full packed channel input (host array or tensor), decodes it
    with its neighbour's halo, and gathers the outputs, so that every rank
    returns (packed output words, message_len): uint32 for b32, uint16 for
    b16, as ViterbiGPU.run returns them.  Each rank's part is
    ``run_sharded``'s."""
    sd, dec_len = shard_stages(cfg, input_num, mesh.size, dec_len)
    out = mesh.all_gather(run_sharded(cfg, sd, mesh, dec_len, packed_global,
                                      backend, survivor)[0])
    m = cfg.get_message_len(input_num)
    return _to_host(out, cfg)[: m // cfg.bits_per_pack], m


def decode_all_ranks(packed_global, input_num: int, cfg: DecoderConfig,
                     num_ranks: int, device="cuda", dec_len=2048,
                     survivor: str = "auto", backend: str = "auto"
                     ) -> Tuple[np.ndarray, int]:
    """decode_sharded over ``num_ranks`` ranks held in this process: each
    rank's plain per-rank decode (``ShardedDecoder.local``) on its shard and
    the first words of the next rank's (cyclic), with no collective.  What
    the real processes must return."""
    mesh = BlockMesh(0, num_ranks, resolve_device(device))
    sd, dec_len = shard_stages(cfg, input_num, num_ranks, dec_len)
    dec, _, local_words, _ = build_sharded_decoder(
        cfg, sd, mesh, dec_len, survivor=survivor, backend=backend)
    words = [rank_words(packed_global, cfg, r, local_words, mesh.device)
             for r in range(num_ranks)]
    outs = [dec.local(words[r], words[(r + 1) % num_ranks]
                      [: dec.halo_words]) for r in range(num_ranks)]
    m = cfg.get_message_len(input_num)
    return _to_host(torch.cat(outs), cfg)[: m // cfg.bits_per_pack], m
