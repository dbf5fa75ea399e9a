"""The in-graph simulation: workload generation, decode and bit-error count
with no host data movement, on one device or over the ranks of a
``BlockMesh``; the counterpart of ``tpu_viterbi/sharding/simulate.py``:

    seed -> message bits -> conv encode -> AWGN -> quantize/pack
         -> decode (ViterbiGPU) -> bit-error count on the device

Generator ``cuda`` is the fused counter-mode kernel (K7 for the integer
channels, K8 for FP32; chain/genkernel.py), the JAX package's ``pallas``;
generator ``torch`` is the element chain (chain/workload.py), its
``xla``.  Without a mesh the decode reads the generated stream as it is
(ViterbiGPU): the kernels zero-fill past a stream's end.  Only the error
count, one scalar, comes back to the host.

With a mesh (``ShardedSimulation``), each rank draws exactly its shard
(``packed_workload_cuda_sharded``: K7/K8 at the shard's base offset),
decodes it with its right neighbour's halo (``blocks.ShardedDecoder``: K1
or K3 reading it as ``tail_halo``, K2 on FP32), counts its bit errors
against its part of the reference, whose realignment needs the neighbour's
first bit pack, and all-reduces the count: one halo exchange, one
one-word exchange and one scalar all-reduce a call (``audit.py``).  The
shard size is JAX's, generator-span and lane-tile alignment included
(``shard_size``), so that the block framing is JAX's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..chain.genkernel import (generator_span_stages, packed_workload_cuda,
                               packed_workload_cuda_sharded,
                               ref_words_from_packs)
from ..chain.workload import packed_workload
from ..config import ChannelIn, DecoderConfig
from ..decoder.api import ViterbiGPU
from ..decoder.core_torch import auto_dec_len
from ..hardware import resolve_device
from ..utils.bits import _popcount32
from ..utils.profile import span
from .blocks import (build_sharded_decoder, sharded_stage_count,
                     zero_copy_align_stages)
from .mesh import BlockMesh

# channel scale per input format (the reference's 40000.0 saturates every
# soft format at main.cpp:137; these keep the soft field in range so the BER
# waterfall is meaningful), copied from the JAX package (simulate.py:49-55)
DEFAULT_SCALES = {
    ChannelIn.HARD: 1.0,
    ChannelIn.SOFT4: 4.0,
    ChannelIn.SOFT8: 32.0,
    ChannelIn.SOFT16: 8192.0,
    ChannelIn.FP32: 4.0,
}


def _bit_packs32(bits: torch.Tensor) -> torch.Tensor:
    """Message bits -> their 32-bit packs at the aligned positions (MSB =
    earliest, zero-padded), int64."""
    pad = (-bits.shape[0]) % 32
    b = torch.cat([bits, bits.new_zeros(pad)]).to(torch.int64).view(-1, 32)
    weights = torch.arange(31, -1, -1, device=bits.device)
    return (b << weights).sum(dim=1)


def _ref_words32(bits: torch.Tensor, extra_l: int, m32: int) -> torch.Tensor:
    """Message bits -> the error-free decoded words as 32-bit packs covering
    m32 decoded bits: pack the bits at their aligned positions, then shift
    by extra_l in pack space."""
    return ref_words_from_packs(_bit_packs32(bits), extra_l, m32)


def count_errors(out: torch.Tensor, ref32: torch.Tensor, bits_per_pack: int,
                 m: int) -> torch.Tensor:
    """Bit errors of the m decoded bits in ``out`` (int32 bit patterns of
    bpp-bit packs) against the 32-bit reference packs ``ref32``: a 0-dim
    int64 tensor on their device.  At bpp 16 the 16-bit packs are held
    against the reference's halves, so m % 32 == 16 counts its last half
    pack (simulate.py:169-184)."""
    if bits_per_pack == 32:
        diff = (out[: m // 32].to(torch.int64) & 0xFFFFFFFF) ^ ref32[: m // 32]
        return _popcount32(diff).sum()
    nh = m // 16
    v = out[:nh].to(torch.int64) & 0xFFFF
    hi = (ref32 >> 16)[: (nh + 1) // 2]
    lo = (ref32 & 0xFFFF)[: nh // 2]
    return _popcount32(v[0::2] ^ hi).sum() + _popcount32(v[1::2] ^ lo).sum()


def resolve_dec_len(dec_len, message_len: int, bits_per_pack: int):
    """The simulation's dec_len: 'auto' sized as the JAX package sizes it,
    from the one-device shard's stage count (message_len rounded up to 32,
    sharding/simulate.py:101-104, blocks.py:31-47), not from the decoded
    length that ViterbiGPU's own 'auto' reads; any other value as given."""
    if dec_len != "auto":
        return dec_len
    return auto_dec_len(-(-message_len // 32) * 32, bits_per_pack)


def _resolve_generator(generator: str, device: torch.device) -> str:
    if generator == "auto":
        generator = "cuda" if device.type == "cuda" else "torch"
    if generator not in ("cuda", "torch"):
        raise ValueError(f"unknown generator {generator!r} "
                         "(expected 'auto', 'cuda' or 'torch')")
    return generator


def shard_size(cfg: DecoderConfig, message_len: int, num_ranks: int,
               dec_len=2048, generator: str = "cuda"):
    """(stages a rank, dec_len) of the sharded simulation, as
    ``tpu_viterbi/sharding/simulate.py:100-136`` sizes them: 'auto' from
    the unaligned shard, the shard aligned to the generator's span
    (``generator_span_stages``) for generator 'cuda' (JAX's 'pallas') where
    the padding stays under 1/8, then to LANE_TILE blocks
    (``zero_copy_align_stages``) where that is compatible and cheap."""
    total, bpp = message_len, cfg.bits_per_pack
    sd = sharded_stage_count(total, num_ranks, bpp)
    if dec_len == "auto":
        dec_len = auto_dec_len(sd, bpp)
    span = generator_span_stages(cfg.channel_in)
    if generator == "cuda":
        sd_al = -(-sd // span) * span
        if sd_al * num_ranks <= total + total // 8:
            sd = sd_al
    al = zero_copy_align_stages(cfg, dec_len)
    if generator != "cuda" or al % span == 0:
        sd = max(sd, sharded_stage_count(total, num_ranks, bpp, align=al))
    return sd, dec_len


class ShardedSimulation:
    """The simulation over the ranks of ``mesh`` (``build_sharded_simulation``
    with a mesh).  ``generate``, ``errors`` and ``decoder.local`` are the
    plain per-rank functions; ``__call__(seed)`` runs this rank's share and
    the exchanges; ``all_ranks(seed)`` runs every rank in this process with
    no collective, what the real processes must agree with."""

    def __init__(self, cfg: DecoderConfig, message_len: int,
                 mesh: BlockMesh, snr_db: float = 5.5, scale: float = None,
                 dec_len=2048, generator: str = "auto",
                 survivor: str = "auto", backend: str = "auto",
                 return_output: bool = False):
        self.m = cfg.get_message_len(2 * message_len)
        if self.m <= 0:
            raise ValueError(f"message_len {message_len} too short to "
                             f"decode")
        self.generator = _resolve_generator(generator, mesh.device)
        self.sd, dec_len = shard_size(cfg, message_len, mesh.size, dec_len,
                                      self.generator)
        self.decoder, _, self.local_words, _ = build_sharded_decoder(
            cfg, self.sd, mesh, dec_len, survivor=survivor, backend=backend)
        self.cfg, self.mesh, self.n = cfg, mesh, message_len
        self.snr_db = snr_db
        self.scale = DEFAULT_SCALES[cfg.channel_in] if scale is None \
            else scale
        self.return_output = return_output

    def generate(self, seed: int, rank: int):
        """Rank ``rank``'s (sd / 32 message-bit packs, local_words channel
        words): K7/K8 at its base offset (generator 'cuda'), or its slice
        of the element chain's whole stream (generator 'torch', drawn
        whole by every rank: a torch.Generator is not counter-mode)."""
        if self.generator == "cuda":
            return packed_workload_cuda_sharded(
                seed, self.n, self.cfg.channel_in, self.snr_db, self.scale,
                self.mesh, min_words=self.mesh.size * self.local_words,
                rank=rank)
        gen = torch.Generator(device=self.mesh.device)
        gen.manual_seed(seed)
        bits, words = packed_workload(gen, self.n, self.cfg.channel_in,
                                      self.snr_db, self.scale)
        lw, pw = self.local_words, self.sd // 32
        return (_slab(_bit_packs32(bits).to(torch.int32), rank * pw, pw),
                _slab(words, rank * lw, lw))

    def errors(self, out: torch.Tensor, packs: torch.Tensor,
               next_pack: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s bit errors: its decoded words against its part
        of the reference, the packs realigned by extra_l with the first
        pack of rank ``rank + 1`` (past m for the last rank: never
        counted), over its decoded bits below m."""
        ref32 = ref_words_from_packs(torch.cat([packs, next_pack]),
                                     self.cfg.extra_l, self.sd)
        m_r = min(max(self.m - rank * self.sd, 0), self.sd)
        return count_errors(out, ref32, self.cfg.bits_per_pack, m_r)

    def __call__(self, seed: int):
        """This rank's share: generate, take the halo and the next bit pack
        from rank (d + 1) mod N, decode, count, all-reduce the count ->
        the global count as a 0-dim tensor on every rank (and this rank's
        decoded words when return_output)."""
        rank = self.mesh.rank
        packs, words = self.generate(seed, rank)
        out = self.decoder(words)
        nxt = self.mesh.shift_left(packs[:1])
        ben = self.mesh.all_reduce_sum(self.errors(out, packs, nxt, rank))
        return (ben, out) if self.return_output else ben

    def all_ranks(self, seed: int):
        """(global count, every rank's decoded words in rank order) of
        ``mesh.size`` ranks held in this process: each rank's plain
        functions, the halo and the next pack taken from the next rank's
        generated slab."""
        n = self.mesh.size
        slabs = [self.generate(seed, r) for r in range(n)]
        hw = self.decoder.halo_words
        outs = [self.decoder.local(slabs[r][1], slabs[(r + 1) % n][1][:hw])
                for r in range(n)]
        ben = sum(self.errors(outs[r], slabs[r][0], slabs[(r + 1) % n][0]
                              [:1], r) for r in range(n))
        return ben, torch.cat(outs)


def _slab(x: torch.Tensor, lo: int, size: int) -> torch.Tensor:
    """x[lo : lo + size], zero past x's end."""
    part = x[lo: lo + size]
    if part.shape[0] < size:
        part = torch.cat([part, part.new_zeros(size - part.shape[0])])
    return part


def build_sharded_simulation(cfg: DecoderConfig, message_len: int,
                             snr_db: float = 5.5, scale: float = None,
                             dec_len=2048, generator: str = "auto",
                             survivor: str = "auto", backend: str = "auto",
                             device="cuda", return_output: bool = False,
                             mesh: BlockMesh = None):
    """-> (simulate(seed), m): simulate runs generate -> decode -> count on
    ``device`` (the GPU unless the caller passes 'cpu') and returns the
    bit-error count over the m decoded bits as a 0-dim tensor there (and
    the decoded words when return_output).  snr_db = math.inf is the noiseless channel.

    generator: 'cuda' = K7/K8 (their plain version on a CPU device, as the
    JAX package's 'pallas' runs in interpret mode off the TPU), 'torch' =
    the element chain; 'auto' = 'cuda' on a GPU, 'torch' on the CPU.  The
    two draw different (equally Gaussian) noise, so their counts differ
    under noise and agree in distribution.  dec_len, survivor and backend
    are ViterbiGPU's; dec_len 'auto' is resolved by resolve_dec_len.

    mesh: None decodes the whole stream on ``device`` as one message.  A
    ``BlockMesh`` (``mesh.make_block_mesh``) runs the multi-rank split on
    its device, ``device`` unused: simulate is a ShardedSimulation, each
    rank's call returns the global count, and with return_output its own
    decoded words (sd bits, the valid prefix of the gathered ranks' being
    m)."""
    if mesh is not None:
        sim = ShardedSimulation(cfg, message_len, mesh, snr_db, scale,
                                dec_len, generator, survivor, backend,
                                return_output)
        return sim, sim.m
    device = resolve_device(device)
    input_num = 2 * message_len
    m = cfg.get_message_len(input_num)
    if m <= 0:
        raise ValueError(f"message_len {message_len} too short to decode")
    generator = _resolve_generator(generator, device)
    if scale is None:
        scale = DEFAULT_SCALES[cfg.channel_in]
    # sized now, so the kernels are built before the first call
    dec = ViterbiGPU(cfg, input_num=input_num,
                     dec_len=resolve_dec_len(dec_len, message_len,
                                             cfg.bits_per_pack),
                     backend=backend, survivor=survivor, device=device)
    m32 = -(-m // 32) * 32

    def simulate(seed: int):
        with span("generate"):
            if generator == "cuda":
                packs, words = packed_workload_cuda(
                    seed, message_len, cfg.channel_in, snr_db, scale, device)
            else:
                gen = torch.Generator(device=device)
                gen.manual_seed(seed)
                bits, words = packed_workload(gen, message_len,
                                              cfg.channel_in, snr_db, scale)
        with span("ref"):
            ref32 = ref_words_from_packs(packs, cfg.extra_l, m32) \
                if generator == "cuda" else \
                _ref_words32(bits, cfg.extra_l, m32)
        out, _ = dec.run_on_device(words, input_num)
        with span("count"):
            ben = count_errors(out, ref32, cfg.bits_per_pack, m)
        return (ben, out) if return_output else ben

    return simulate, m


def simulate_sharded(cfg: DecoderConfig, message_len: int,
                     snr_db: float = 5.5, seed: int = 0, scale: float = None,
                     dec_len=2048, generator: str = "auto",
                     survivor: str = "auto", backend: str = "auto",
                     device="cuda", mesh: BlockMesh = None
                     ) -> Tuple[int, int]:
    """One-shot: -> (bit_error_count, message_len); ``mesh`` as
    build_sharded_simulation takes it."""
    fn, m = build_sharded_simulation(cfg, message_len, snr_db=snr_db,
                                     scale=scale, dec_len=dec_len,
                                     generator=generator, survivor=survivor,
                                     backend=backend, device=device,
                                     mesh=mesh)
    return int(fn(seed)), m
