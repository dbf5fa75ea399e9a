"""Block-parallel Viterbi decoder core in plain PyTorch.

Port of ``tpu_viterbi/decoder/core_xla.py`` (itself the batched form of the
reference's fused persistent kernel, src/viterbi/viterbi.cu:144-207):

  - B independent overlap-save time-blocks batched on the last axis of
    (64, B) path-metric tensors; one Python loop over stages advances every
    block in lockstep;
  - the two trellis predecessors of state s are s >> 1 and (s >> 1) + 32
    (trellis.py), so the gathered predecessor metrics are pairwise row
    repeats of the lower/upper half of the state axis;
  - register exchange: survivor packs dumped every bits_per_pack stages to
    an (n_packs, 64, B) store, then a pack-granular traceback from state 0.

It holds the plain version of every decode kernel (core_cuda.py), each
computing its kernel's function: ``decode_blocks_torch`` (K1, K2, K3 on
packed words), ``decode_staged_torch`` (K4 on staged words or values),
``decode_planes_torch`` (K5 on two f32 planes), ``stage_transpose``
(K6) and ``decode_ud_words_torch`` (K1 and K3 on the FP32 channel's u/d
words of ``fp32_ud_words_torch``); ``decode_blocks_i16_torch``,
``decode_staged_i16_torch`` and ``decode_planes_i16_torch``, the int16
arithmetic of K1-K3, K4 and K5 (``Pm16``), which the tests and
``chip_smoke.py`` hold against the int32 decode (no decode path calls
them); and the values-in entry
``decode_blocks`` with ``gather_blocks``, ``forward_scan`` and
``traceback_scan``, as the JAX package exports them.
The CPU tests hold it bit-exact against ``decode_packed_xla`` and
``core_xla.decode_blocks``, and ``chip_smoke.py`` holds the kernels
against it on the card.  It runs on the CPU or on CUDA tensors.

All metric modes run on int32 path metrics, as the TPU kernel does
(core_pallas.py:140-148): the reference sizes renorm strides so b16/fp16
metrics decode identically to int32 (tests/test_metric_equiv.py locks the
identity on the JAX side).  K1-K5 run int16 metrics on every input but
SOFT16 and K4's unclamped f32 values, renormalised once a pack, which
decodes identically for the same reason (``decode_blocks_i16_torch`` and
its K4 and K5 siblings).  Survivor registers are
int64 masked to 32 bits, because torch's uint32 support is partial and
``>>`` on int32 is arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import FP_PRECISION, ChannelIn, DecoderConfig, NUM_STATES
from ..trellis import BRANCH_CODE_J0
from ..utils.bits import to_int32_bits

WARMUP = 64          # extra_l + extra_r stages per block (viterbi.h:73-76)

# Minimum depth in ACS stages of the windowed survivor's per-pack chase
# (core_pallas.py:82-88): a 32-stage chase measured ~3x the full store's
# error count in the JAX package, so bpp 16 chases as many stages as bpp 32.
WINDOW_MIN_CHASE_STAGES = 64


@dataclass(frozen=True)
class BlockPlan:
    """Static partition of a message into equal overlap-save blocks.

    All blocks decode `dec_len` output bits from `dec_len + 64` input
    stages; block k starts at k*dec_len.  The last block's span may run
    past message_len; only its first dec_len - overlap_bits bits are kept
    (assemble_output), the rest — decoded from the zero-padded stream
    tail — are discarded ("natural" framing, as in the JAX package)."""

    message_len: int
    dec_len: int
    num_blocks: int
    bits_per_pack: int

    @property
    def block_len(self) -> int:  # ACS stages per block
        return self.dec_len + WARMUP

    @property
    def n_packs(self) -> int:  # survivor packs per block
        return self.block_len // self.bits_per_pack

    @property
    def overlap_bits(self) -> int:  # discarded tail bits of the last block
        return self.num_blocks * self.dec_len - self.message_len

    def offsets(self) -> np.ndarray:
        return np.arange(self.num_blocks, dtype=np.int32) * self.dec_len


def plan_from_reference(plan) -> BlockPlan:
    """The port's plan equal to ``plan``, any object with the reference
    BlockPlan's four fields (duck-typed: the port never imports the JAX
    package)."""
    return BlockPlan(int(plan.message_len), int(plan.dec_len),
                     int(plan.num_blocks), int(plan.bits_per_pack))


def plan_blocks(message_len: int, bits_per_pack: int,
                dec_len: int = 2048) -> BlockPlan:
    if message_len % bits_per_pack:
        raise ValueError("message_len must be a multiple of bits_per_pack")
    dec_len = max(bits_per_pack, min(dec_len, message_len))
    dec_len -= dec_len % bits_per_pack
    num_blocks = -(-message_len // dec_len)
    return BlockPlan(message_len, dec_len, num_blocks, bits_per_pack)


def auto_dec_len(message_len: int, bits_per_pack: int,
                 preferred: int = 8192, lane_tile: int = 128) -> int:
    """Message-size-aware dec_len, the JAX package's rule (core_xla.py:106):
    `preferred` for large messages, else small enough that the block count
    fills `lane_tile` blocks, floor 64.  Kept for parity of the
    ``--dec-len auto`` flag; the GPU's own choice awaits measurement."""
    if message_len >= preferred * lane_tile:
        return preferred
    dl = -(-message_len // lane_tile)
    dl = -(-dl // bits_per_pack) * bits_per_pack
    return max(WARMUP, min(preferred, dl))


_MAX_ABS_BM = {ChannelIn.HARD: 2, ChannelIn.SOFT4: 16,
               ChannelIn.SOFT8: 256, ChannelIn.SOFT16: 65536,
               ChannelIn.FP32: 16}


def needs_int32_renorm(cfg: DecoderConfig, plan: BlockPlan) -> bool:
    """int32 path metrics run renorm-free while block_len * max|bm| < 2^30
    (blocks reset PMs to zero); past that the cores subtract the 64-state
    minimum once per pack, which never changes a compare (reference:
    viterbiACS.cuh:307-378).  SOFT16 at dec_len >= ~16K is the binding
    case."""
    return plan.block_len * _MAX_ABS_BM[cfg.channel_in] >= (1 << 30)


def words_per_block(cfg: DecoderConfig, plan: BlockPlan):
    """(wpb, wph): body words per block and halo words after it.  Block k
    reads words [k*wpb, k*wpb + wpb + wph).  FP32 values count as one-value
    words."""
    dpp = 1 if cfg.channel_in == ChannelIn.FP32 else cfg.enc_data_per_pack
    return 2 * plan.dec_len // dpp, 2 * WARMUP // dpp


def traceback_shape(cfg: DecoderConfig, plan: BlockPlan):
    """(n_conv, n_emit): packs discarded for convergence from the last
    pack, then packs emitted per block."""
    bpp = plan.bits_per_pack
    return -(-(cfg.extra_r - bpp) // bpp), plan.dec_len // bpp


_FP_LO = -(1 << (FP_PRECISION - 1))       # the FP32 window [-8, 7]
_FP_HI = (1 << (FP_PRECISION - 1)) - 1


def overlapped_windows(x: torch.Tensor, stride: int, win: int,
                       num: int) -> torch.Tensor:
    """(N, ...) stream -> (num, ..., win) strided view of the overlapping
    windows x[k*stride : k*stride + win] (core_xla.overlapped_windows; the
    window axis last, as ``unfold`` gives it).  The stream is zero-filled
    past its end, so a window may span several following strides."""
    need = (num - 1) * stride + win
    if x.shape[0] < need:
        x = torch.cat([x, x.new_zeros((need - x.shape[0],) + x.shape[1:])])
    return x[:need].unfold(0, win, stride)


def block_words(packed: torch.Tensor, cfg: DecoderConfig,
                plan: BlockPlan) -> torch.Tensor:
    """Packed channel words -> (B, Lw) block-major per-block word windows
    (a strided view), Lw = wpb + wph: block k's words [k*wpb, k*wpb + Lw)."""
    wpb, wph = words_per_block(cfg, plan)
    return overlapped_windows(packed, wpb, wpb + wph, plan.num_blocks)


def stage_transpose(x: torch.Tensor, stride: int, win: int,
                    num: int) -> torch.Tensor:
    """The plain version of kernel K6: a flat stream of 32-bit words (int32
    or float32) -> the contiguous (win, num) word-major layout
    out[i, k] = x[k*stride + i], zero past the stream's end."""
    return overlapped_windows(x, stride, win, num).t().clone(
        memory_format=torch.contiguous_format)


def stage_words(packed: torch.Tensor, cfg: DecoderConfig,
                plan: BlockPlan) -> torch.Tensor:
    """Packed channel words -> (Lw, B) word-major block layout, equal to
    ``core_xla.stage_words(packed, cfg, plan, b_pad=B)``: column k holds
    block k's Lw = wpb + wph words.  FP32 values count as one-value words.
    K6's plain version at (stride, win) = (wpb, Lw)."""
    wpb, wph = words_per_block(cfg, plan)
    return stage_transpose(packed, wpb, wpb + wph, plan.num_blocks)


def block_major_words(packed: torch.Tensor, cfg: DecoderConfig,
                      plan: BlockPlan, b_pad: int):
    """Packed channel words -> (body (b_pad, wpb), halo (b_pad, wph)), the
    block-major layouts of ``core_pallas._block_major_words`` (:765): the
    stream zero-padded to b_pad * wpb + wpb + wph words, the body its first
    b_pad * wpb words cut into rows, the halo block k's first wph words
    after its body (overlapped windows, so they may span several bodies
    when dec_len < 64).  Rows past the plan's blocks hold the stream's
    words there."""
    wpb, wph = words_per_block(cfg, plan)
    need = b_pad * wpb + wpb + wph
    if packed.shape[0] < need:
        packed = torch.cat([packed, packed.new_zeros(need - packed.shape[0])])
    body = packed[: b_pad * wpb].reshape(b_pad, wpb)
    return body, overlapped_windows(packed[wpb:], wpb, wph, b_pad)


def unpack_words(wt: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """(Lw, B) word-major integer channel words -> (Lw * dpp / 2, 2, B)
    int32 stage pairs.  Fields are MSB-first; HARD bits map to +-1, soft
    fields are sign-extended (core_xla.stage_layout_packed, :230-243)."""
    dpp, width = cfg.enc_data_per_pack, cfg.enc_data_width
    u = wt.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(dpp - 1, -1, -1, device=wt.device) * width
    vals = (u[:, None, :] >> shifts[:, None]) & ((1 << width) - 1)
    if cfg.channel_in == ChannelIn.HARD:
        vals = vals * 2 - 1
    else:
        half = 1 << (width - 1)
        vals = ((vals + half) & ((1 << width) - 1)) - half
    return vals.to(torch.int32).reshape(wt.shape[0] * dpp // 2, 2,
                                        wt.shape[1])


def stage_values(packed: torch.Tensor, cfg: DecoderConfig,
                 plan: BlockPlan) -> torch.Tensor:
    """Packed channel words -> (block_len, 2, B) per-stage soft pairs
    (port of core_xla.stage_layout_packed, :212-245), unpacked from the
    block-major windows read column-wise.  FP32 values are clamped to the
    FP_PRECISION window (viterbiBM.cuh:139-151)."""
    wt = block_words(packed, cfg, plan).t()               # (Lw, B) view
    if cfg.channel_in == ChannelIn.FP32:
        return wt.clamp(_FP_LO, _FP_HI).reshape(plan.block_len, 2, -1)
    return unpack_words(wt, cfg)


def clamp_split(wt: torch.Tensor, plan: BlockPlan):
    """(2 * block_len, B) word-major f32 wire -> (r0, r1), two (n_packs,
    bpp, B) views of the even and odd rows of its FP_PRECISION clamp
    (``torch.clamp`` keeps a NaN a NaN, as ``jnp.clip`` does)."""
    v = wt.clamp(_FP_LO, _FP_HI)
    shp = (plan.n_packs, plan.bits_per_pack, wt.shape[1])
    return v[0::2].reshape(shp), v[1::2].reshape(shp)


def stage_floats_2streams(packed: torch.Tensor, cfg: DecoderConfig,
                          plan: BlockPlan):
    """FP32 interleaved value stream -> two (n_packs, bpp, B) f32 planes
    (r0 stream, r1 stream), clamped to the FP_PRECISION window: the port of
    core_xla.stage_floats_2streams (:298-316) at b_pad = B, the input of
    kernel K5."""
    return clamp_split(stage_words(packed.to(torch.float32), cfg, plan),
                       plan)


def gather_blocks(r: torch.Tensor, plan: BlockPlan) -> torch.Tensor:
    """Global (S, 2) soft stage pairs -> (B, L, 2) per-block windows, the
    last block's tail zero-filled (core_xla.gather_blocks, :153)."""
    return overlapped_windows(r, plan.dec_len, plan.block_len,
                              plan.num_blocks).transpose(1, 2)


# BPSK sign of each expected coded bit on the j=0 branch, per state:
# +1 where the expected bit is 1 (correlation convention of the reference's
# dp2a/dp4a coefficient tables, viterbiBM.cuh:45-124).
_SIGN0_NP = (2 * ((BRANCH_CODE_J0 >> 1) & 1) - 1).astype(np.int32)[:, None]
_SIGN1_NP = (2 * (BRANCH_CODE_J0 & 1) - 1).astype(np.int32)[:, None]


def _branch_metrics(r0, r1, s0, s1, is_float: bool, ud: bool = False):
    """(64, B) int32 j=0 branch metrics bmA[s] = sign0[s]*r0 + sign1[s]*r1
    (reference: viterbiBM.cuh dp2a/dp4a correlations with +-1 coeffs); the
    FP32 correlation is truncated toward zero (viterbiBM.cuh:128-153).  The
    j=1 metric is -bmA (see _acs_stage).  ``ud``: r0, r1 are the stage's
    (u, d) = (r0 + r1, r0 - r1) themselves, so bmA[s] = sign0[s] * (u where
    the two signs agree, else d) (core_pallas.py:600-602).

    A NaN on the FP32 wire survives the clamp and makes a NaN correlation;
    it becomes 0, and an unclamped value beyond the int32 range (the
    values-in entry does not clamp) saturates, as XLA's float->int32
    conversion does in the JAX core (core_xla.py:331-337); torch's gives
    INT32_MIN for both on the CPU, so the conversion clamps through
    int64."""
    if ud:
        return s0 * torch.where(s0 == s1, r0[None, :], r1[None, :])
    bm = s0 * r0[None, :] + s1 * r1[None, :]
    return trunc_int32(bm) if is_float else bm


def trunc_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 toward zero as XLA converts: saturating at the int32
    range, NaN to 0 (``_branch_metrics``' conversion)."""
    return (torch.trunc(x).nan_to_num(nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31)
            .to(torch.int64).clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32))


def _repeat2(x):
    """Pairwise row repeat [x0, x0, x1, x1, ...]."""
    h, b = x.shape
    return x[:, None, :].expand(h, 2, b).reshape(2 * h, b)


class Pm16:
    """The int16 path metrics of ``csrc/acs.cuh`` (``acs_stage16`` and
    ``renorm16``), which K1-K5 run on every input but SOFT16 and K4's
    unclamped f32 values: each
    candidate metric is computed exactly, then wrapped to int16 as
    VIADD.16x2 wraps it, and compared in int16 with the same tie rule (the
    j=0 branch wins ties); once a pack, after the survivor dump, state 0's
    metric is subtracted from all 64 (``renorm``; without it the metrics
    wrap on long blocks and the decode goes wrong, which the tests show).
    With ``track_peak``, ``peak`` holds the largest |candidate| before the
    wrap (a 0-dim int32 tensor, so the scan never waits on the device):
    while it stays at or under 32,767 nothing wrapped, and the decode
    equals the int32 one."""

    def __init__(self, renorm: bool = True, track_peak: bool = False):
        self.renorm = renorm
        self.track_peak = track_peak
        self.peak = None

    def wrap(self, cand0, cand1):
        """The candidates in int16; with ``track_peak`` note their largest
        exact |c| first."""
        if self.track_peak:
            top = torch.maximum(cand0.abs().amax(), cand1.abs().amax())
            self.peak = top if self.peak is None else torch.maximum(
                self.peak, top)
        return cand0.to(torch.int16), cand1.to(torch.int16)


def _acs_stage(pm, pp, bm_a, pm16: Pm16 = None):
    """One add-compare-select stage over all 64 states x B blocks.

    bm_a is the j=0 branch metric per state; the j=1 metric is exactly -bm_a
    because both generator polynomials tap the dropped bit b_{t-6}, so
    flipping j flips both coded bits and negates the correlation.  With
    ``pm16`` the metrics are int16 and the candidates wrap (``Pm16``)."""
    cand0 = _repeat2(pm[:32]) + bm_a         # predecessors s >> 1
    cand1 = _repeat2(pm[32:]) - bm_a         # predecessors (s >> 1) + 32
    if pm16 is not None:
        cand0, cand1 = pm16.wrap(cand0, cand1)
    dec = cand1 > cand0                      # tie -> j=0 (matches golden)
    pm_new = torch.where(dec, cand1, cand0)
    pp_sel = torch.where(dec, _repeat2(pp[32:]), _repeat2(pp[:32]))
    pp_new = ((pp_sel << 1) | dec.to(torch.int64)) & 0xFFFFFFFF
    return pm_new, pp_new


def _pack_scan(rs: torch.Tensor, cfg: DecoderConfig, plan: BlockPlan,
               ud: bool = False, pm16: Pm16 = None):
    """ACS over all stages of all blocks from the stage pairs, (n_packs,
    bpp, 2, B) or its (block_len, 2, B) view, as f32 (FP32) or int32; with
    ``ud`` int32 (u, d) pairs (``_branch_metrics``).  Yields each survivor
    pack (64, B) int64, masked to bits_per_pack bits, as its last stage
    completes.  Path metrics: int32, the per-pack minimum subtracted where
    ``needs_int32_renorm``; with ``pm16`` int16 (``Pm16``)."""
    b = rs.shape[-1]
    bpp = plan.bits_per_pack
    is_float = cfg.channel_in == ChannelIn.FP32 and not ud
    renorm = needs_int32_renorm(cfg, plan)
    dt = torch.float32 if is_float else torch.int32
    rs = rs.reshape(plan.block_len, 2, b).to(dt)
    s0 = torch.as_tensor(_SIGN0_NP, device=rs.device).to(dt)
    s1 = torch.as_tensor(_SIGN1_NP, device=rs.device).to(dt)
    pm = torch.zeros((NUM_STATES, b), device=rs.device,
                     dtype=torch.int32 if pm16 is None else torch.int16)
    pp = torch.zeros((NUM_STATES, b), dtype=torch.int64, device=rs.device)
    for p in range(plan.n_packs):
        for t in range(p * bpp, (p + 1) * bpp):
            bm_a = _branch_metrics(rs[t, 0], rs[t, 1], s0, s1, is_float, ud)
            pm, pp = _acs_stage(pm, pp, bm_a, pm16)
        yield pp & ((1 << bpp) - 1)
        # once per pack, as the kernels do (decision-invariant)
        if pm16 is not None:
            if pm16.renorm:
                pm = pm - pm[:1]
        elif renorm:
            pm = pm - pm.min(dim=0, keepdim=True).values


def forward_scan_staged(rs: torch.Tensor, cfg: DecoderConfig,
                        plan: BlockPlan, ud: bool = False,
                        pm16: Pm16 = None) -> torch.Tensor:
    """ACS from the scan-major (n_packs, bpp, 2, B) stage layout (or its
    (block_len, 2, B) view), as core_xla.forward_scan_staged (:394).
    Returns the full survivor store, all packs (n_packs, 64, B) int64."""
    surv = torch.empty((plan.n_packs, NUM_STATES, rs.shape[-1]),
                       dtype=torch.int64, device=rs.device)
    for p, pack in enumerate(_pack_scan(rs, cfg, plan, ud, pm16)):
        surv[p] = pack
    return surv


def forward_scan(r_blocks: torch.Tensor, cfg: DecoderConfig,
                 plan: BlockPlan) -> torch.Tensor:
    """ACS over all stages for all blocks from (B, L, 2) soft values, as
    core_xla.forward_scan (:382).  Returns (n_packs, 64, B) int64."""
    return forward_scan_staged(r_blocks.permute(1, 2, 0), cfg, plan)


def traceback_scan(surv: torch.Tensor, cfg: DecoderConfig,
                   plan: BlockPlan) -> torch.Tensor:
    """Pack-granular state chase from state 0 on the last pack: discard
    n_conv packs, then emit n_emit packs; next state = the pack's oldest 6
    decisions.  Returns (B, n_emit) int64 packs, oldest first."""
    n_conv, n_emit = traceback_shape(cfg, plan)
    shift = plan.bits_per_pack - 6
    state = torch.zeros((1, surv.shape[2]), dtype=torch.int64,
                        device=surv.device)
    packs = []
    for k in range(n_conv + n_emit):
        pack = surv[plan.n_packs - 1 - k].gather(0, state)
        if k >= n_conv:
            packs.append(pack[0])
        state = (pack >> shift) & 63          # packs are non-negative
    return torch.stack(packs[::-1], dim=1)


def survivor_window_slots(cfg: DecoderConfig) -> int:
    """Slots W of the windowed survivor ring (core_pallas.py:295-315): a
    per-pack chase reads slots p .. p - n_disc while the next dump frees
    the oldest, so W = n_disc + 2, with n_disc = max(n_conv + 1,
    ceil(WINDOW_MIN_CHASE_STAGES / bpp)) discard packs: 4 slots at bpp 32,
    6 at bpp 16."""
    bpp = cfg.bits_per_pack
    n_conv = -(-(cfg.extra_r - bpp) // bpp)
    return max(n_conv + 1, -(-WINDOW_MIN_CHASE_STAGES // bpp)) + 2


def _chase(ring: torch.Tensor, slots, b: int, bpp: int) -> torch.Tensor:
    """Fresh traceback from state 0 through ring[slots[0]],
    ring[slots[1]], ...; returns the (B,) pack read from the last slot."""
    state = torch.zeros((1, b), dtype=torch.int64, device=ring.device)
    for slot in slots:
        pack = ring[slot].gather(0, state)
        state = (pack >> (bpp - 6)) & 63
    return pack[0]


def window_scan(rs: torch.Tensor, cfg: DecoderConfig,
                plan: BlockPlan, ud: bool = False,
                pm16: Pm16 = None) -> torch.Tensor:
    """The windowed survivor (core_pallas.py:440-486, the reference's
    one-pointer circular buffer): survivor pack p goes to ring slot p mod W
    and, once p - n_disc >= emit_lo, a fresh chase from state 0 through
    n_disc discard packs emits pack p - n_disc.  After the loop the top
    packs q, which have less history by framing, are chased at their full
    available depth n_packs - 1 - q.  Returns (B, n_emit) int64 packs.

    Equal to the full store on coded input; on random words the two
    legitimately differ (tests/test_survivor_window.py)."""
    b, bpp, n_packs = rs.shape[-1], plan.bits_per_pack, plan.n_packs
    n_conv, n_emit = traceback_shape(cfg, plan)
    w = survivor_window_slots(cfg)
    n_disc = w - 2
    emit_lo = n_packs - n_conv - n_emit
    ring = torch.empty((w, NUM_STATES, b), dtype=torch.int64,
                       device=rs.device)
    out = torch.empty((b, n_emit), dtype=torch.int64, device=rs.device)
    for p, pack in enumerate(_pack_scan(rs, cfg, plan, ud, pm16)):
        ring[p % w] = pack
        if p - n_disc >= emit_lo:
            out[:, p - n_disc - emit_lo] = _chase(
                ring, [(p - t) % w for t in range(n_disc + 1)], b, bpp)
    for q in range(max(emit_lo, n_packs - n_disc), n_packs - n_conv):
        out[:, q - emit_lo] = _chase(
            ring, [(n_packs - 1 - t) % w for t in range(n_packs - q)], b,
            bpp)
    return out


def assemble_output(out_packs: torch.Tensor, cfg: DecoderConfig,
                    plan: BlockPlan) -> torch.Tensor:
    """(B, n_emit) per-block packs -> flat packed output words.

    Blocks 0..B-2 contribute their full span; the last block contributes
    only its first dec_len - overlap_bits bits, so the decoded stream
    covers exactly [0, message_len) with the reference's bit<->pack mapping
    (MSB = earliest, main.cpp:160).  The dtype passes through: the cores
    give int32 bit patterns, read as uint32 (or uint16 at bpp 16) at the
    numpy boundary (api.ViterbiGPU.run)."""
    del cfg
    ov_words = plan.overlap_bits // plan.bits_per_pack
    n_emit = out_packs.shape[1]
    return torch.cat([out_packs[:-1].reshape(-1),
                      out_packs[-1, : n_emit - ov_words]])


def _decode_stages(rs: torch.Tensor, cfg: DecoderConfig, plan: BlockPlan,
                   window: bool, ud: bool = False,
                   pm16: Pm16 = None) -> torch.Tensor:
    """Stage pairs ((u, d) pairs with ``ud``) -> (B, n_emit) int32 output
    packs, full store or window, on int32 metrics or ``pm16``'s."""
    if window:
        return to_int32_bits(window_scan(rs, cfg, plan, ud, pm16))
    surv = forward_scan_staged(rs, cfg, plan, ud, pm16)
    return to_int32_bits(traceback_scan(surv, cfg, plan))


TAIL_HALO_REFUSAL = ("tail_halo requires the fused roll-halo integer path "
                     "(dec_len >= 64, fused=True)")


def check_tail_halo(tail_halo, cfg: DecoderConfig, plan: BlockPlan,
                    fused: bool = True) -> None:
    """Refuse a tail halo where the JAX entry does, with its words
    (core_pallas.py:1183-1185): the FP32 channel, ``fused=False`` and
    dec_len < 64 raise ValueError.  (The JAX entry drops a halo given with
    FP32 silently, its FP32 branch returning before the check; here it is
    refused.)  A halo must be the wph words of ``words_per_block``.  JAX's
    lane-tile assert (num_blocks == b_pad, :858-859) guards the TPU's
    staging into tile-edge rows, which the flat reader does not have, so
    it is not carried over: the halo follows the stream wherever it ends."""
    if cfg.channel_in == ChannelIn.FP32 or not fused \
            or plan.dec_len < WARMUP:
        raise ValueError(TAIL_HALO_REFUSAL)
    wph = words_per_block(cfg, plan)[1]
    if tail_halo.dim() != 1 or tail_halo.shape[0] != wph:
        raise ValueError(f"tail_halo must be the {wph} words of "
                         f"{cfg.channel_in.name}'s halo, got "
                         f"{tuple(tail_halo.shape)}")


def with_tail_halo(packed: torch.Tensor, tail_halo, cfg: DecoderConfig,
                   plan: BlockPlan) -> torch.Tensor:
    """The stream a decode with ``tail_halo`` reads: ``packed`` with the
    halo appended (zeros after it, as after any stream); the plain
    versions' meaning of the kernels' tail halo."""
    if tail_halo is None:
        return packed
    check_tail_halo(tail_halo, cfg, plan)
    return torch.cat([packed.to(torch.int32), tail_halo.to(torch.int32)])


def decode_blocks_torch(packed: torch.Tensor, cfg: DecoderConfig,
                        plan: BlockPlan, window: bool = False,
                        tail_halo: torch.Tensor = None) -> torch.Tensor:
    """Packed channel words -> (B, n_emit) int32 output packs: the plain
    version of the kernels (core_cuda), same inputs, same outputs — K1
    (integer channels) and K2 (FP32) with the full survivor store, K3 with
    ``window=True``.  ``tail_halo``: the wph words that follow the stream
    (integer channels, dec_len >= 64; ``with_tail_halo``)."""
    is_float = cfg.channel_in == ChannelIn.FP32
    packed = with_tail_halo(packed, tail_halo, cfg, plan)
    packed = packed.to(torch.float32 if is_float else torch.int32)
    return _decode_stages(stage_values(packed, cfg, plan), cfg, plan, window)


def staged_word_mode(staged: torch.Tensor, cfg: DecoderConfig,
                     plan: BlockPlan) -> bool:
    """Which staged input K4 was given: True for (Lw, B) word-major channel
    words (an integer channel, K6's output at (wpb, Lw)), False for (2 *
    block_len, B) values, r0 and r1 of stage t in rows 2t and 2t + 1 (K6's
    output on the (S, 2) values or the f32 wire).  Raises ValueError on any
    other shape."""
    wpb, wph = words_per_block(cfg, plan)
    b = plan.num_blocks
    if staged.dim() == 2 and staged.shape[1] == b:
        if staged.shape[0] == 2 * plan.block_len:
            return False
        if cfg.channel_in != ChannelIn.FP32 and staged.shape[0] == wpb + wph:
            return True
    raise ValueError(
        f"K4 takes ({wpb + wph}, {b}) staged words or "
        f"({2 * plan.block_len}, {b}) staged values for this "
        f"{cfg.channel_in.name} plan, got {tuple(staged.shape)}")


# The int16 path metrics (csrc/acs.cuh, acs_stage16 and renorm16): the
# largest |bm| of each input that takes them, and the largest |candidate
# metric| that renormalising once a pack allows: the spread of the 64
# metrics is at most 12 max|bm| (every state reaches every other in 6
# stages), and a pack adds at most bpp max|bm|.  HARD, SOFT4 and SOFT8
# hold for their words (K1, K3, K4) and their integer values in the field
# range (K4); ChannelIn.FP32 is the channel's u/d words (K1 and K3 in ud
# mode), their fields read as they are, 8 bits each; FP32_WIRE the raw f32
# wire (K2, K3) and K5's planes: the clamp to [-8, 7] keeps |u| and |d| at
# or under 16, a NaN truncates to 0.
# PM16_BOUND is acs.cuh's kPm16Bound, SOFT8 at bpp 32.
FP32_WIRE = "FP32 wire"
PM16_MAX_ABS_BM = {**{c: _MAX_ABS_BM[c] for c in (
    ChannelIn.HARD, ChannelIn.SOFT4, ChannelIn.SOFT8)}, ChannelIn.FP32: 128,
    FP32_WIRE: _MAX_ABS_BM[ChannelIn.FP32]}


def pm16_bound(max_abs_bm: int, bits_per_pack: int) -> int:
    """The largest |candidate metric| of the int16 stage on an input of
    that max|bm| at that pack width."""
    return (12 + bits_per_pack) * max_abs_bm


PM16_BOUND = pm16_bound(PM16_MAX_ABS_BM[ChannelIn.SOFT8], 32)


def pm16_input(cfg: DecoderConfig, ud: bool = False):
    """The key of ``PM16_MAX_ABS_BM`` for this input: the channel, or
    FP32_WIRE for the FP32 channel's raw wire or K5's planes (``ud``
    False)."""
    if cfg.channel_in == ChannelIn.FP32 and not ud:
        return FP32_WIRE
    return cfg.channel_in


def decode_blocks_i16_torch(packed: torch.Tensor, cfg: DecoderConfig,
                            plan: BlockPlan, ud: bool = False,
                            renorm: bool = True, return_peak: bool = False,
                            window: bool = False,
                            tail_halo: torch.Tensor = None):
    """The int16 arithmetic of K1, K2 and K3 in plain torch (``Pm16``):
    packed channel words, the FP32 channel's f32 wire, or with ``ud`` its
    u/d words (and the FP32 ``cfg``) -> (B, n_emit) int32 output packs,
    full store or ``window``; ``decode_blocks_torch`` (or
    ``decode_ud_words_torch``) on int16 metrics.  ``renorm``: ``Pm16``'s.
    With ``return_peak`` it also returns the largest |candidate| before the
    wrap.  ``tail_halo``: ``decode_blocks_torch``'s.  SOFT16 raises
    ValueError: the kernels keep int32 metrics there (its |bm| reaches
    65,536)."""
    is_float = cfg.channel_in == ChannelIn.FP32
    if (ud and not is_float) or cfg.channel_in == ChannelIn.SOFT16:
        raise ValueError(f"the kernels run int16 metrics on HARD, SOFT4, "
                         f"SOFT8 and the FP32 channel's wire and u/d words, "
                         f"not {cfg.channel_in.name}"
                         f"{' u/d words' if ud else ''}")
    if tail_halo is not None:
        check_tail_halo(tail_halo, cfg, plan)
    if ud:
        rs = ud_stage_pairs(packed, plan)
    else:
        packed = with_tail_halo(packed, tail_halo, cfg, plan)
        packed = packed.to(torch.float32 if is_float else torch.int32)
        rs = stage_values(packed, cfg, plan)
    return _decode_i16(rs, cfg, plan, window, renorm, return_peak, ud)


def _decode_i16(rs: torch.Tensor, cfg: DecoderConfig, plan: BlockPlan,
                window: bool, renorm: bool, return_peak: bool,
                ud: bool = False):
    """``_decode_stages`` on int16 metrics (``Pm16``): the packs, and with
    ``return_peak`` the largest |candidate| before the wrap."""
    pm16 = Pm16(renorm, return_peak)
    packs = _decode_stages(rs, cfg, plan, window, ud, pm16)
    return (packs, int(pm16.peak)) if return_peak else packs


def decode_staged_torch(staged: torch.Tensor, cfg: DecoderConfig,
                        plan: BlockPlan, window: bool = False
                        ) -> torch.Tensor:
    """The plain version of kernel K4: staged input (``staged_words``) ->
    (B, n_emit) int32 output packs.  Words are unpacked as K1 unpacks them;
    values decode as given (int32, or f32 for FP32: not clamped)."""
    return _decode_stages(_staged_stage_pairs(staged, cfg, plan), cfg, plan,
                          window)


def _staged_stage_pairs(staged: torch.Tensor, cfg: DecoderConfig,
                        plan: BlockPlan) -> torch.Tensor:
    """K4's staged input -> its stage pairs: words unpacked as K1 unpacks
    them, values as given."""
    if staged_word_mode(staged, cfg, plan):
        return unpack_words(staged.to(torch.int32), cfg)
    return staged.reshape(plan.block_len, 2, plan.num_blocks)


def decode_staged_i16_torch(staged: torch.Tensor, cfg: DecoderConfig,
                            plan: BlockPlan, window: bool = False,
                            renorm: bool = True, return_peak: bool = False):
    """The int16 arithmetic of K4 in plain torch (``Pm16``): staged words
    or integer values of HARD, SOFT4 or SOFT8 -> (B, n_emit) int32 output
    packs, full store or ``window``; ``decode_staged_torch`` on int16
    metrics.  Values must lie in the channel's field range, which bounds
    their |bm| as the words' (``PM16_MAX_ABS_BM``).  ``renorm`` and
    ``return_peak``: ``decode_blocks_i16_torch``'s.  SOFT16 and the FP32
    channel's f32 values raise ValueError: K4 keeps int32 metrics there
    (|bm| to 65,536; unclamped values saturate at +-2^31)."""
    if cfg.channel_in in (ChannelIn.SOFT16, ChannelIn.FP32):
        what = "f32 values" if cfg.channel_in == ChannelIn.FP32 else "input"
        raise ValueError(f"K4 runs int16 metrics on HARD, SOFT4 and SOFT8 "
                         f"words and values, not {cfg.channel_in.name} "
                         f"{what}")
    return _decode_i16(_staged_stage_pairs(staged, cfg, plan), cfg, plan,
                       window, renorm, return_peak)


def _planes_stage_pairs(r0: torch.Tensor, r1: torch.Tensor,
                        plan: BlockPlan) -> torch.Tensor:
    """Two planes, (n_packs, bpp, B) or (block_len, B) each -> (block_len,
    2, B) stage pairs."""
    shp = (plan.block_len, plan.num_blocks)
    return torch.stack([r0.reshape(shp), r1.reshape(shp)], dim=1)


def decode_planes_torch(r0: torch.Tensor, r1: torch.Tensor,
                        cfg: DecoderConfig, plan: BlockPlan,
                        window: bool = False) -> torch.Tensor:
    """The plain version of kernel K5: the two f32 planes of
    ``stage_floats_2streams``, (n_packs, bpp, B) or (block_len, B) each ->
    (B, n_emit) int32 output packs.  The planes decode as given: the clamp
    is the staging's."""
    return _decode_stages(_planes_stage_pairs(r0, r1, plan), cfg, plan,
                          window)


def decode_planes_i16_torch(r0: torch.Tensor, r1: torch.Tensor,
                            cfg: DecoderConfig, plan: BlockPlan,
                            window: bool = False, renorm: bool = True,
                            return_peak: bool = False):
    """The int16 arithmetic of K5 in plain torch (``Pm16``):
    ``decode_planes_torch`` on int16 metrics.  The planes must be clamped
    to [-8, 7] (NaN aside), as the staging clamps them: that is the FP32
    wire's bound (``PM16_MAX_ABS_BM[FP32_WIRE]``).  ``renorm`` and
    ``return_peak``: ``decode_blocks_i16_torch``'s.  Another channel than
    FP32 raises ValueError, as K5 decodes FP32 only."""
    if cfg.channel_in != ChannelIn.FP32:
        raise ValueError(f"K5 runs int16 metrics on the FP32 channel's "
                         f"clamped planes, not {cfg.channel_in.name}")
    return _decode_i16(_planes_stage_pairs(r0, r1, plan), cfg, plan, window,
                       renorm, return_peak)


def fp32_ud_words_torch(vals: torch.Tensor) -> torch.Tensor:
    """FP32 interleaved channel values -> the FP32 channel's u/d words, the
    counterpart of ``core_xla.fp32_ud_words`` (:248-295; XLA there, plain
    torch ops here): per stage (u, d) = (trunc(r0 + r1), trunc(r0 - r1))
    after the clamp to [-8, 7], packed as a SOFT8 stream — 4 signed 8-bit
    fields a word, MSB first, [u, d] interleaved per stage.  The values are
    zero-padded to a multiple of 256 (128 stages), so the output has
    padded / 4 int32 words.  u and d lie in [-16, 14]: 8-bit fields are
    exact, and trunc is odd, so K1 on these words decodes as K2 on the wire.

    +-inf saturate in the clamp.  A NaN makes every (u, d) of its 128-value
    row 0, as in the XLA staging: its deinterleave is two one-hot matmuls,
    so the NaN spreads over the row (0 x NaN = NaN), and XLA converts NaN
    to 0."""
    v = vals.to(torch.float32).reshape(-1).clamp(_FP_LO, _FP_HI)
    pad = (-v.shape[0]) % 256
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    rows = v.reshape(-1, 128)
    bad = rows.isnan().any(dim=1, keepdim=True)
    r0, r1 = rows[:, 0::2], rows[:, 1::2]                # (rows, 64) stages
    # fields in [-16, 14]: exact in int32; the packing's shifts wrap there
    q = torch.stack([(r0 + r1).masked_fill(bad, 0.0).to(torch.int32),
                     (r0 - r1).masked_fill(bad, 0.0).to(torch.int32)],
                    dim=-1).reshape(-1, 4) & 0xFF        # [u, d, u, d] a word
    return (q[:, 0] << 24) | (q[:, 1] << 16) | (q[:, 2] << 8) | q[:, 3]


def ud_words_per_block(plan: BlockPlan):
    """(wpb, wph) of the u/d words: SOFT8's framing, 4 fields a word
    (core_pallas.py:896: wph = 2 * WARMUP // 4)."""
    return 2 * plan.dec_len // 4, 2 * WARMUP // 4


def ud_stage_pairs(udw: torch.Tensor, plan: BlockPlan) -> torch.Tensor:
    """u/d words -> (block_len, 2, B) int32 (u, d) pairs of every block,
    halo included, zero past the stream's end."""
    wpb, wph = ud_words_per_block(plan)
    wt = overlapped_windows(udw.to(torch.int32), wpb, wpb + wph,
                            plan.num_blocks).t()
    return unpack_words(wt, DecoderConfig(ChannelIn.SOFT8))


def decode_ud_words_torch(udw: torch.Tensor, cfg: DecoderConfig,
                          plan: BlockPlan, window: bool = False
                          ) -> torch.Tensor:
    """The plain version of K1 (K3 with ``window``) on the FP32 channel's
    u/d words (``fp32_ud_words_torch``): (B, n_emit) int32 output packs.
    ``cfg`` is the FP32 configuration: it gives the pack width and the
    renorm rule."""
    return _decode_stages(ud_stage_pairs(udw, plan), cfg, plan, window,
                          ud=True)


def decode_blocks(r_blocks: torch.Tensor, cfg: DecoderConfig,
                  plan: BlockPlan) -> torch.Tensor:
    """Full block-parallel decode: (B, L, 2) soft values -> flat int32
    packed output words (core_xla.decode_blocks, :483).  FP32 values are
    not clamped."""
    surv = forward_scan(r_blocks, cfg, plan)
    return assemble_output(to_int32_bits(traceback_scan(surv, cfg, plan)),
                           cfg, plan)


def decode_packed_torch(packed: torch.Tensor, cfg: DecoderConfig,
                        plan: BlockPlan, window: bool = False,
                        tail_halo: torch.Tensor = None) -> torch.Tensor:
    """Full decode straight from packed channel words (the
    ViterbiCUDA::run input format, viterbi.cu:211-238) -> flat int32
    packed output words.  Counterpart of ``decode_packed_xla`` (and of
    ``decode_packed_pallas(..., window=True)`` with ``window=True``);
    ``tail_halo`` as ``decode_packed_pallas`` takes it."""
    return assemble_output(decode_blocks_torch(packed, cfg, plan, window,
                                               tail_halo), cfg, plan)
