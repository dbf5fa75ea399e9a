"""Fused workload generator: message bits -> convolutional encode -> AWGN
-> quantize -> packed channel words in one kernel, the counterpart of
``tpu_viterbi/chain/genkernel.py``.

Kernels K7 (the four integer channels) and K8 (the FP32 wire) are CUDA C++
in ``csrc/genkernel.cu``, built into the package's one library
(``library.load_library``).  Their CTAs draw each message-bit pack once,
into shared memory: ``threefry_calls`` counts the draws of each design on
the host.  ``K7_OLD`` and ``K8_OLD`` draw as the first design did (every
thread draws its window's two packs), kept for an A/B on the card and
launched by no main path.  Beside them, their plain PyTorch
version over flat index tensors: ``gen_words_torch`` (the body of the TPU
kernel's ``_gen_kernel``, naive window branch) and ``gen_values_torch``
(``_gen_kernel_f32``).  A wrapper runs the plain version for a CPU device
and launches its kernel (or raises) for a CUDA device.

The random streams are the JAX kernel's: threefry2x32 at 13 rounds in
counter mode, message-bit pack p from counter (p >> 1, 1), the noise of
stage j of channel word w from (w, 2 + j) (FP32: stage s from (s, 2)),
Box-Muller over 24-bit uniforms.  So for one seed the port and the JAX
package draw the same message bits and, up to an ulp of f32 log/sin/cos,
the same noise.  Every value is a function of the key and its position:
``base`` generates the slice of the stream from that word on.

The 32-bit arithmetic is done on uint32 bit patterns held in int64 tensors
(every result masked to 32 bits): torch's ``>>`` on int32 is arithmetic,
where the JAX kernel shifts logically.  Outputs are int32 bit patterns, as
the JAX kernel's.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import library
from ..config import CONST_LEN, POLY1, POLY2, ChannelIn
from ..hardware import resolve_device
from ..utils.bits import to_int32_bits
from ..utils.profile import span
from .channel import snr_to_sigma
from .quantize import _QUANT_PARAMS

M32 = 0xFFFFFFFF
GEN_ROUNDS = 13          # the BigCrush-passing minimum (genkernel.py:78-85)
GEN_THREADS = 256        # a CTA of K7/K8 (csrc/genkernel.cu kGenThreads)
_ROTS = (13, 15, 26, 6, 17, 29, 16, 24)
_BITS_TAG = 1            # threefry c1 of the message-bit draws
_NOISE_TAG = 2           # threefry c1 base of the noise draws
_TWO_PI_F32 = float(np.float32(2.0 * math.pi))
SOURCE = library.CSRC / "genkernel.cu"


def _u32(x):
    """A Python int or an integer tensor -> its uint32 bit pattern (int64
    tensor, or int)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1, rounds: int = 20):
    """threefry2x32 of counters (c0, c1) under key (k0, k1): ints or
    integer tensors, read as uint32 bit patterns; returns two int64 tensors
    of uint32 values.  At the default 20 rounds it equals
    ``jax._src.prng.threefry_2x32``; key injection every 4 rounds and after
    the last, so any ``rounds`` is defined (genkernel.py:92-113)."""
    k0, k1, c0, c1 = _u32(k0), _u32(k1), _u32(c0), _u32(c1)
    ks = (k0, k1, 0x1BD11BDA ^ k0 ^ k1)
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32
    r = g = 0
    while r < rounds:
        base = 4 * (g % 2)
        for i in range(min(4, rounds - r)):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, _ROTS[base + i]) ^ x0
        r += min(4, rounds - r)
        g += 1
        x0 = (x0 + ks[g % 3]) & M32
        x1 = (x1 + ks[(g + 1) % 3] + g) & M32
    return x0, x1


def normal_pair(x0: torch.Tensor, x1: torch.Tensor):
    """Two integer tensors of random words -> two independent N(0, 1) f32
    draws by Box-Muller over 24-bit uniforms (genkernel.py:116-129)."""
    two24 = 2.0 ** -24
    u1 = ((x0 & 0xFFFFFF).to(torch.float32) + 1.0) * two24
    u2 = (x1 & 0xFFFFFF).to(torch.float32) * two24
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI_F32 * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _bit_pack(k0, k1, idx: torch.Tensor) -> torch.Tensor:
    """Message-bit packs ``idx`` (MSB = earliest): half idx & 1 of the
    threefry call (idx >> 1, 1); packs at negative indices are zero."""
    x0, x1 = threefry2x32(k0, k1, idx >> 1, _BITS_TAG, GEN_ROUNDS)
    return torch.where(idx < 0, 0, torch.where((idx & 1) == 1, x1, x0))


def _bit_packs(k0, k1, n: int, first: int, device,
               end: int = None) -> torch.Tensor:
    """Packs first .. min(end, ceil(n/32)) - 1 as int32, bits past n
    zeroed."""
    last = -(-n // 32) if end is None else min(end, -(-n // 32))
    p = torch.arange(first, last, device=device, dtype=torch.int64)
    keep = torch.clamp(n - 32 * p, 0, 32)
    mask = (M32 << (32 - keep)) & M32      # keep 32 -> shift 0, 0 -> 0
    return to_int32_bits(_bit_pack(k0, k1, p) & mask)


def _tap_ds(poly: int):
    return tuple(CONST_LEN - 1 - b for b in range(CONST_LEN)
                 if (poly >> b) & 1)


_TAPS_D0 = _tap_ds(POLY1)   # (6, 3, 2, 1, 0)
_TAPS_D1 = _tap_ds(POLY2)   # (6, 5, 3, 2, 0)


def _parity_windows(k0, k1, first: torch.Tensor):
    """The encoder's two parity windows for stages first .. first + 25:
    bit 25 - j of each is out0 / out1 of stage first + j.  The window holds
    message bits first - 6 .. first + 25 from the MSB, cut from the two
    covering packs; ``>> 5`` and ``& 31`` floor for the negative offset of
    the first word, as JAX's int32 shifts do."""
    off = first - (CONST_LEN - 1)
    pk, sh = off >> 5, off & 31
    p1, p2 = _bit_pack(k0, k1, pk), _bit_pack(k0, k1, pk + 1)
    u = ((p1 << sh) & M32) | (p2 >> (32 - sh))   # p2 < 2^32: >> 32 is 0
    o0 = o1 = 0
    for d in _TAPS_D0:
        o0 = o0 ^ (u >> d)
    for d in _TAPS_D1:
        o1 = o1 ^ (u >> d)
    return o0, o1


def _channel_value(bit, f_scale: float, f_nscale: float, z):
    """BPSK of ``bit`` times scale, plus nscale * z (z None: noiseless)."""
    v = (bit.to(torch.float32) * 2.0 - 1.0) * f_scale
    return v if z is None else v + f_nscale * z


def _f32_scales(scale: float, sigma: float):
    """scale and scale * sigma rounded once to f32 (the product taken in
    float64, genkernel.py:265), as the kernels receive them."""
    return float(np.float32(scale)), float(np.float32(scale * sigma))


def threefry_calls(n: int, channel_in: ChannelIn, base: int = 0,
                   shared: bool = True, noisy: bool = True) -> int:
    """threefry calls a K7/K8 launch draws for message length ``n`` from
    word ``base`` (FP32: value) on: each CTA's window packs, one call a
    pair of packs from its first thread's first pack to its last thread's
    second (``shared``, csrc/genkernel.cu's ``fill_packs``), or two a
    thread (the first design, K7_OLD/K8_OLD), no call for a negative
    pack; plus one noise call a stage of every thread when ``noisy``."""
    if channel_in == ChannelIn.FP32:
        spt, first, n_out = 1, base // 2, n - base // 2
    else:
        vpw = word_format(channel_in)[1]
        spt, n_out = vpw // 2, -(-2 * n // vpw) - base
        first = base * spt
    hist = CONST_LEN - 1
    noise = n_out * spt if noisy else 0
    if not shared:      # only a first stage below 6 has a negative pack
        negative = min(n_out, max(0, -(-(hist - first) // spt)))
        return 2 * n_out - negative + noise
    cta = first + spt * GEN_THREADS * np.arange(-(-n_out // GEN_THREADS),
                                                dtype=np.int64)
    even = ((cta - hist) >> 5) & ~1
    hi = ((cta + (GEN_THREADS - 1) * spt - hist) >> 5) + 1
    q_first = np.maximum(even >> 1, 0)
    return int(np.maximum((hi >> 1) - q_first + 1, 0).sum()) + noise


def word_format(channel_in: ChannelIn):
    """(width, vpw, wpl): field bits, values per word, words per bit pack."""
    if channel_in == ChannelIn.FP32:
        raise ValueError("FP32 channel has no packed-word form; K8 writes "
                         "its f32 values")
    width = 1 if channel_in == ChannelIn.HARD else \
        _QUANT_PARAMS[channel_in][0]
    return width, 32 // width, 64 // (32 // width)


def gen_words_torch(k0, k1, n: int, channel_in: ChannelIn, sigma: float,
                    scale: float, base: int = 0, device="cpu",
                    count: int = None):
    """Plain version of K7: -> (bit packs from pack base / wpl, int32;
    channel words from word ``base``, int32), the slices from there of
    ``packed_workload_pallas``'s ceil(n/32) packs and ceil(2n/vpw) words:
    ``count`` words (all to the end by default) and the packs whose first
    word is among them.  sigma 0 is the noiseless channel."""
    width, vpw, wpl = word_format(channel_in)
    spw = vpw // 2
    f_scale, f_nscale = _f32_scales(scale, sigma)
    end = -(-2 * n // vpw) if count is None else base + count
    w = torch.arange(base, end, device=device, dtype=torch.int64)
    o0, o1 = _parity_windows(k0, k1, w * spw)
    acc = torch.zeros_like(w)
    for j in range(spw):
        zs = (None, None)
        if sigma:
            zs = normal_pair(*threefry2x32(k0, k1, w, _NOISE_TAG + j,
                                           GEN_ROUNDS))
        stage_ok = w * spw + j < n            # one stage per message bit
        for stream, o in enumerate((o0, o1)):
            v = _channel_value((o >> (25 - j)) & 1, f_scale, f_nscale,
                               zs[stream])
            if channel_in == ChannelIn.HARD:
                field = (v > 0.0).to(torch.int64)
            else:
                _, lo, hi = _QUANT_PARAMS[channel_in]
                field = torch.clamp(torch.round(v), lo, hi).to(torch.int64)
                field = field & ((1 << width) - 1)
            field = torch.where(stage_ok, field, 0)
            acc = acc | (field << (32 - (2 * j + stream + 1) * width))
    return (_bit_packs(k0, k1, n, base // wpl, device, -(-end // wpl)),
            to_int32_bits(acc))


def gen_values_torch(k0, k1, n: int, sigma: float, scale: float,
                     base: int = 0, device="cpu", count: int = None):
    """Plain version of K8: -> (bit packs from pack base / 64, int32; the
    FP32 wire's 2n interleaved f32 values [r0, r1] per stage from value
    ``base`` on: ``count`` values, all to the end by default, and the
    packs whose first value is among them), one noise pair per stage."""
    f_scale, f_nscale = _f32_scales(scale, sigma)
    end = 2 * n if count is None else base + count
    s = torch.arange(base // 2, end // 2, device=device, dtype=torch.int64)
    o0, o1 = _parity_windows(k0, k1, s)
    zs = (None, None)
    if sigma:
        zs = normal_pair(*threefry2x32(k0, k1, s, _NOISE_TAG, GEN_ROUNDS))
    vals = torch.stack([_channel_value((o >> 25) & 1, f_scale, f_nscale, z)
                        for o, z in zip((o0, o1), zs)], dim=1).reshape(-1)
    return _bit_packs(k0, k1, n, base // 64, device, -(-end // 64)), vals


class GenKernel:
    """Wrapper of generator kernel K7 (``fp32`` False) or K8 (True), bound
    to its entry point ``viterbi_<name>_launch`` of the package's library.
    ``launches`` counts kernel launches and nothing else (plain-version
    calls for a CPU device do not count)."""

    def __init__(self, name: str, fp32: bool):
        self.name = name
        self.entry = f"viterbi_{name.lower()}_launch"
        self.source = SOURCE
        self.fp32 = fp32
        self.launches = 0
        self._fn = None

    def build(self) -> None:
        """Build and load the library (once a process), bind the entry."""
        if self._fn is not None:
            return
        vp, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                             ctypes.c_float)
        self._fn = library.bind(
            self.entry,
            [vp, vp, i32, i32, i32, u32, u32, f32, f32, i32, vp] if self.fp32
            else [vp, vp, i32, i32, i32, i32, u32, u32, i32, f32, f32, i32,
                  vp])

    def __call__(self, k0: int, k1: int, n: int, channel_in: ChannelIn,
                 sigma: float, scale: float, base: int = 0,
                 device="cuda", count: int = None, size: int = None):
        """-> (bit packs, channel words or f32 values) from word ``base``
        on (a multiple of the words per bit pack; FP32: of 64 values), for
        message length ``n`` and noise sigma (0: noiseless): ``count``
        words (FP32: values, an even number), all to the stream's end by
        default, and the bit packs whose first word is among them.
        ``size`` (a multiple of the words per pack, at least ``count``):
        the outputs come ``size`` words and ``size`` / (words per pack)
        packs long, zero past what was drawn (a shard past the stream's
        end), the kernel writing into them.  On ``device``
        (``hardware.resolve_device``: the card, which must be present,
        unless the caller asks for the CPU, where the plain version
        runs)."""
        if (channel_in == ChannelIn.FP32) != self.fp32:
            other = "K7" if self.fp32 else "K8"
            raise ValueError(f"kernel {self.name} does not generate the "
                             f"{channel_in.name} channel; {other} does")
        if self.fp32:
            quantum, n_out = 64, 2 * n
        else:
            _, vpw, quantum = word_format(channel_in)
            n_out = -(-2 * n // vpw)
        if not 0 < 2 * n < 2 ** 31:
            raise ValueError(f"message length {n} out of range: positions "
                             f"are int32")
        if base % quantum or not 0 <= base < n_out:
            raise ValueError(f"base {base} must be a multiple of {quantum} "
                             f"in [0, {n_out})")
        if count is None:
            count = n_out - base
        if not 0 < count <= n_out - base or (self.fp32 and count % 2):
            raise ValueError(f"count {count} must be in [1, {n_out - base}]"
                             f"{', even' if self.fp32 else ''}")
        if size is not None and (size < count or size % quantum):
            raise ValueError(f"size {size} must be a multiple of {quantum} "
                             f"of at least count {count}")
        device = resolve_device(device)
        if device.type == "cpu":
            if self.fp32:
                out = gen_values_torch(k0, k1, n, sigma, scale, base, device,
                                       count)
            else:
                out = gen_words_torch(k0, k1, n, channel_in, sigma, scale,
                                      base, device, count)
            if size is None:
                return out
            return tuple(torch.cat([x, x.new_zeros(want - x.shape[0])])
                         for x, want in zip(out, (size // quantum, size)))
        if device.type != "cuda":
            raise ValueError(f"{self.name} runs on CPU or CUDA devices, got "
                             f"{device}")
        self.build()
        f_scale, f_nscale = _f32_scales(scale, sigma)
        n_packs = -(-n // 32)
        n_bits = min(n_packs, -(-(base + count) // quantum)) - base // quantum
        bits = torch.empty(n_bits if size is None else size // quantum,
                           dtype=torch.int32, device=device)
        out = torch.empty(count if size is None else size, device=device,
                          dtype=torch.float32 if self.fp32 else torch.int32)
        bits[n_bits:].zero_()
        out[count:].zero_()
        noisy = int(bool(sigma))
        with torch.cuda.device(device), span(self.name):
            stream = torch.cuda.current_stream(device).cuda_stream
            if self.fp32:
                err = self._fn(bits.data_ptr(), out.data_ptr(), n, base // 2,
                               count // 2, k0, k1, f_scale, f_nscale,
                               noisy, stream)
            else:
                err = self._fn(bits.data_ptr(), out.data_ptr(), n, base,
                               count, n_packs, k0, k1,
                               word_format(channel_in)[0], f_scale, f_nscale,
                               noisy, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError_t "
                               f"{err}")
        self.launches += 1
        return bits, out


K7 = GenKernel("K7", fp32=False)
K8 = GenKernel("K8", fp32=True)
KERNELS = (K7, K8)
# the first design's draws (each thread draws its two window packs): for
# the A/B on the card only, never launched by a main path
K7_OLD = GenKernel("K7_OLD", fp32=False)
K8_OLD = GenKernel("K8_OLD", fp32=True)


def key_data(seed: int):
    """The two uint32 key words of ``seed`` as ``jax.random.PRNGKey(seed)``
    gives them in JAX's default 32-bit mode: (0, the low 32 bits)."""
    return 0, int(seed) & M32


def kernel_for(channel_in: ChannelIn) -> GenKernel:
    """The kernel that generates ``channel_in``'s stream: K8 for FP32,
    K7 for the integer channels."""
    return K8 if channel_in == ChannelIn.FP32 else K7


def packed_workload_cuda(seed: int, n: int, channel_in: ChannelIn,
                         snr_db: float, scale: float, device="cuda",
                         base: int = 0, count: int = None, size: int = None):
    """Fused generation of the in-graph simulation's workload (the
    counterpart of ``packed_workload_pallas``): K7 for the integer channels,
    K8 for FP32, on ``device`` (the GPU unless the caller passes 'cpu',
    where their plain version runs).  snr_db = inf is the noiseless
    channel.

    -> (bit packs, ceil(n/32) int32 [message bits, MSB = earliest];
        channel stream: ceil(2n/vpw) int32 words, or for FP32 the 2n
        interleaved scaled f32 values), both from word ``base`` on
        (``count`` words of it in outputs of ``size``: GenKernel's)."""
    device = resolve_device(device)
    k0, k1 = key_data(seed)
    sigma = 0.0 if math.isinf(snr_db) else snr_to_sigma(snr_db)
    return kernel_for(channel_in)(k0, k1, n, channel_in, sigma, scale, base,
                                  device, count, size)


# the JAX kernel's requested rows a program (genkernel.py:61), rounded up
# per channel by _plan / _plan_f32: the sharded simulation's sizes read it
GEN_ROWS = 64
_F32_ROW_QUANTUM = 512   # genkernel.py:355: 8 x 64 values a bit pack


def generator_span_stages(channel_in: ChannelIn, rows: int = GEN_ROWS) -> int:
    """Coded stages one program of the JAX generator kernel covers, with
    JAX's numbers (genkernel.py:418-426): rows x 128 words x vpw / 2
    stages (FP32: rows x 128 values = rows x 64 stages), rows rounded up
    to 8 x wpl (FP32: to 512).  K7 and K8 need no such span; the sharded
    simulation sizes its shards by it (sharding/simulate.py:114-126), so
    that its block framing is JAX's."""
    if channel_in == ChannelIn.FP32:
        rows = -(-rows // _F32_ROW_QUANTUM) * _F32_ROW_QUANTUM
        return rows * 128 // 2
    _, vpw, wpl = word_format(channel_in)
    rows = -(-rows // (8 * wpl)) * (8 * wpl)
    return rows * 128 * vpw // 2


def packed_workload_cuda_sharded(seed: int, n: int, channel_in: ChannelIn,
                                 snr_db: float, scale: float, mesh,
                                 min_words: int = 0, rank: int = None):
    """This rank's slab of ``packed_workload_cuda``'s streams (the
    counterpart of ``packed_workload_pallas_sharded``): the stream padded
    with zero words to at least ``min_words`` and to a whole number of bit
    packs a rank, cut into ``mesh.size`` equal slabs; rank d draws exactly
    its slab through K7's / K8's ``base`` offset, on ``mesh.device``.
    Counter mode makes every slab the same bits as the one-rank stream's,
    so no reshard is ever needed.

    -> (bit packs: the slab's, w_loc / wpl int32, zero past the message;
        words: w_loc int32 words, or FP32 values, zero past the stream).
    ``rank``: another rank's slab (for the ranks held in one process),
    by default ``mesh.rank``'s."""
    rank = mesh.rank if rank is None else rank
    if channel_in == ChannelIn.FP32:       # q: the words of one bit pack
        n_out, dtype, q = 2 * n, torch.float32, 64
    else:
        _, vpw, q = word_format(channel_in)
        n_out, dtype = -(-2 * n // vpw), torch.int32
    w_loc = -(-max(n_out, min_words) // (mesh.size * q)) * q
    lo = rank * w_loc
    count = min(n_out, lo + w_loc) - lo
    dev = mesh.device
    if count <= 0:                      # a slab past the stream's end
        return (torch.zeros(w_loc // q, dtype=torch.int32, device=dev),
                torch.zeros(w_loc, dtype=dtype, device=dev))
    return packed_workload_cuda(seed, n, channel_in, snr_db, scale, dev,
                                base=lo, count=count, size=w_loc)


def ref_words_from_packs(bit_packs: torch.Tensor, extra_l: int,
                         message_len: int) -> torch.Tensor:
    """Aligned message-bit packs -> the words a decode without error gives:
    decoded bit i = message bit i + extra_l (main.cpp:160-161), 32-bit
    packs, MSB = earliest.  -> int64 tensor of uint32 values
    (genkernel.py:552-566)."""
    nw = message_len // 32
    w = _u32(bit_packs)
    if w.shape[0] < nw + 1:
        w = torch.cat([w, w.new_zeros(nw + 1 - w.shape[0])])
    return ((w[:nw] << extra_l) & M32) | (w[1:nw + 1] >> (32 - extra_l))
