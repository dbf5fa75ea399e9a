"""The in-graph simulation on one device: workload generation, decode and
bit-error count with no host data movement, the one-device counterpart of
``tpu_viterbi/sharding/simulate.py``:

    seed -> message bits -> conv encode -> AWGN -> quantize/pack
         -> decode (ViterbiGPU) -> bit-error count on the device

Generator ``cuda`` is the fused counter-mode kernel (K7 for the integer
channels, K8 for FP32; chain/genkernel.py), the JAX package's ``pallas``;
generator ``torch`` is the element chain (chain/workload.py), its
``xla``.  The decode reads the generated stream as it is: the kernels
zero-fill past a stream's end, so none of the TPU's span alignment
(``generator_span_stages``, ``zero_copy_align_stages``) is needed.  Only
the error count, one scalar, comes back to the host.

The multi-rank form (a halo send between ranks, the count all-reduced over
``torch.distributed``) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..chain.genkernel import packed_workload_cuda, ref_words_from_packs
from ..chain.workload import packed_workload
from ..config import ChannelIn, DecoderConfig
from ..decoder.api import ViterbiGPU
from ..decoder.core_torch import auto_dec_len
from ..hardware import resolve_device
from ..utils.bits import _popcount32

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


def _ref_words32(bits: torch.Tensor, extra_l: int, m32: int) -> torch.Tensor:
    """Message bits -> the error-free decoded words as 32-bit packs covering
    m32 decoded bits: pack the bits at their aligned positions (MSB =
    earliest, zero-padded), then shift by extra_l in pack space."""
    pad = (-bits.shape[0]) % 32
    b = torch.cat([bits, bits.new_zeros(pad)]).to(torch.int64).view(-1, 32)
    weights = torch.arange(31, -1, -1, device=bits.device)
    return ref_words_from_packs((b << weights).sum(dim=1), extra_l, m32)


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


def build_sharded_simulation(cfg: DecoderConfig, message_len: int,
                             snr_db: float = 5.5, scale: float = None,
                             dec_len=2048, generator: str = "auto",
                             survivor: str = "auto", backend: str = "auto",
                             device="cuda", return_output: bool = False):
    """-> (simulate(seed), m): simulate runs generate -> decode -> count on
    ``device`` (the GPU unless the caller passes 'cpu') and returns the
    bit-error count over the m decoded bits as a 0-dim tensor there (and
    the decoded words when return_output).  snr_db = math.inf is the noiseless channel.

    generator: 'cuda' = K7/K8 (their plain version on a CPU device, as the
    JAX package's 'pallas' runs in interpret mode off the TPU), 'torch' =
    the element chain; 'auto' = 'cuda' on a GPU, 'torch' on the CPU.  The
    two draw different (equally Gaussian) noise, so their counts differ
    under noise and agree in distribution.  dec_len, survivor and backend
    are ViterbiGPU's; dec_len 'auto' is resolved by resolve_dec_len."""
    device = resolve_device(device)
    input_num = 2 * message_len
    m = cfg.get_message_len(input_num)
    if m <= 0:
        raise ValueError(f"message_len {message_len} too short to decode")
    if generator == "auto":
        generator = "cuda" if device.type == "cuda" else "torch"
    if generator not in ("cuda", "torch"):
        raise ValueError(f"unknown generator {generator!r} "
                         "(expected 'auto', 'cuda' or 'torch')")
    if scale is None:
        scale = DEFAULT_SCALES[cfg.channel_in]
    # sized now, so the kernels are built before the first call
    dec = ViterbiGPU(cfg, input_num=input_num,
                     dec_len=resolve_dec_len(dec_len, message_len,
                                             cfg.bits_per_pack),
                     backend=backend, survivor=survivor, device=device)
    m32 = -(-m // 32) * 32

    def simulate(seed: int):
        if generator == "cuda":
            packs, words = packed_workload_cuda(
                seed, message_len, cfg.channel_in, snr_db, scale, device)
            ref32 = ref_words_from_packs(packs, cfg.extra_l, m32)
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            bits, words = packed_workload(gen, message_len, cfg.channel_in,
                                          snr_db, scale)
            ref32 = _ref_words32(bits, cfg.extra_l, m32)
        out, _ = dec.run_on_device(words, input_num)
        ben = count_errors(out, ref32, cfg.bits_per_pack, m)
        return (ben, out) if return_output else ben

    return simulate, m


def simulate_sharded(cfg: DecoderConfig, message_len: int,
                     snr_db: float = 5.5, seed: int = 0, scale: float = None,
                     dec_len=2048, generator: str = "auto",
                     survivor: str = "auto", backend: str = "auto",
                     device="cuda") -> Tuple[int, int]:
    """One-shot: -> (bit_error_count, message_len)."""
    fn, m = build_sharded_simulation(cfg, message_len, snr_db=snr_db,
                                     scale=scale, dec_len=dec_len,
                                     generator=generator, survivor=survivor,
                                     backend=backend, device=device)
    return int(fn(seed)), m
