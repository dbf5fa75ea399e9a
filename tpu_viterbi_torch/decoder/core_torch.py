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

This is the plain version beside kernel K1 (core_cuda.py), computing the
same function: the CPU tests hold it bit-exact against
``decode_packed_xla``, and ``chip_smoke.py`` holds K1 against it on the
card.  It runs on the CPU or on CUDA tensors.

All metric modes run on int32 path metrics, as the TPU kernel and K1 do
(core_pallas.py:140-148): the reference sizes renorm strides so b16/fp16
metrics decode identically to int32 (tests/test_metric_equiv.py locks the
identity on the JAX side).  Survivor registers are int64 masked to 32 bits,
because torch's uint32 support is partial and ``>>`` on int32 is
arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import FP_PRECISION, ChannelIn, DecoderConfig, NUM_STATES
from ..trellis import BRANCH_CODE_J0
from ..utils.bits import to_int32_bits

WARMUP = 64          # extra_l + extra_r stages per block (viterbi.h:73-76)


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


def stage_words(packed: torch.Tensor, cfg: DecoderConfig,
                plan: BlockPlan) -> torch.Tensor:
    """Packed channel words -> (B, Lw) overlapping per-block word windows
    (a strided view; the stream is zero-filled past its end).  A block's
    halo may span several following bodies when dec_len < 64."""
    wpb, wph = words_per_block(cfg, plan)
    lw = wpb + wph
    need = (plan.num_blocks - 1) * wpb + lw
    if packed.shape[0] < need:
        packed = torch.cat([packed,
                            packed.new_zeros(need - packed.shape[0])])
    return packed[:need].unfold(0, lw, wpb)


def stage_values(packed: torch.Tensor, cfg: DecoderConfig,
                 plan: BlockPlan) -> torch.Tensor:
    """Packed channel words -> (block_len, 2, B) per-stage soft pairs
    (port of core_xla.stage_layout_packed, :212-245).  Fields are MSB-first;
    HARD bits map to +-1, soft fields are sign-extended, FP32 values are
    clamped to the FP_PRECISION window (viterbiBM.cuh:139-151)."""
    wt = stage_words(packed, cfg, plan)                   # (B, Lw)
    b = plan.num_blocks
    if cfg.channel_in == ChannelIn.FP32:
        lo = -(1 << (FP_PRECISION - 1))
        hi = (1 << (FP_PRECISION - 1)) - 1
        vals = wt.clamp(lo, hi)
    else:
        dpp, width = cfg.enc_data_per_pack, cfg.enc_data_width
        u = wt.to(torch.int64) & 0xFFFFFFFF
        shifts = torch.arange(dpp - 1, -1, -1, device=wt.device) * width
        vals = (u[..., None] >> shifts) & ((1 << width) - 1)
        if cfg.channel_in == ChannelIn.HARD:
            vals = vals * 2 - 1
        else:
            half = 1 << (width - 1)
            vals = ((vals + half) & ((1 << width) - 1)) - half
        vals = vals.to(torch.int32)
    return vals.reshape(b, plan.block_len, 2).permute(1, 2, 0)


# BPSK sign of each expected coded bit on the j=0 branch, per state:
# +1 where the expected bit is 1 (correlation convention of the reference's
# dp2a/dp4a coefficient tables, viterbiBM.cuh:45-124).
_SIGN0_NP = (2 * ((BRANCH_CODE_J0 >> 1) & 1) - 1).astype(np.int32)[:, None]
_SIGN1_NP = (2 * (BRANCH_CODE_J0 & 1) - 1).astype(np.int32)[:, None]


def _branch_metrics(r0, r1, s0, s1, is_float: bool):
    """(64, B) int32 j=0 branch metrics bmA[s] = sign0[s]*r0 + sign1[s]*r1
    (reference: viterbiBM.cuh dp2a/dp4a correlations with +-1 coeffs); the
    FP32 correlation is truncated toward zero (viterbiBM.cuh:128-153).  The
    j=1 metric is -bmA (see _acs_stage)."""
    bm = s0 * r0[None, :] + s1 * r1[None, :]
    return torch.trunc(bm).to(torch.int32) if is_float else bm


def _repeat2(x):
    """Pairwise row repeat [x0, x0, x1, x1, ...]."""
    h, b = x.shape
    return x[:, None, :].expand(h, 2, b).reshape(2 * h, b)


def _acs_stage(pm, pp, bm_a):
    """One add-compare-select stage over all 64 states x B blocks.

    bm_a is the j=0 branch metric per state; the j=1 metric is exactly -bm_a
    because both generator polynomials tap the dropped bit b_{t-6}, so
    flipping j flips both coded bits and negates the correlation."""
    cand0 = _repeat2(pm[:32]) + bm_a         # predecessors s >> 1
    cand1 = _repeat2(pm[32:]) - bm_a         # predecessors (s >> 1) + 32
    dec = cand1 > cand0                      # tie -> j=0 (matches golden)
    pm_new = torch.where(dec, cand1, cand0)
    pp_sel = torch.where(dec, _repeat2(pp[32:]), _repeat2(pp[:32]))
    pp_new = ((pp_sel << 1) | dec.to(torch.int64)) & 0xFFFFFFFF
    return pm_new, pp_new


def forward_scan(rs: torch.Tensor, cfg: DecoderConfig,
                 plan: BlockPlan) -> torch.Tensor:
    """ACS over all stages of all blocks from the (block_len, 2, B) stage
    pairs.  Returns the survivor packs (n_packs, 64, B) int64, each masked
    to bits_per_pack bits."""
    b = rs.shape[2]
    bpp = plan.bits_per_pack
    is_float = cfg.channel_in == ChannelIn.FP32
    renorm = needs_int32_renorm(cfg, plan)
    dt = torch.float32 if is_float else torch.int32
    s0 = torch.as_tensor(_SIGN0_NP, device=rs.device).to(dt)
    s1 = torch.as_tensor(_SIGN1_NP, device=rs.device).to(dt)
    pm = torch.zeros((NUM_STATES, b), dtype=torch.int32, device=rs.device)
    pp = torch.zeros((NUM_STATES, b), dtype=torch.int64, device=rs.device)
    surv = torch.empty((plan.n_packs, NUM_STATES, b), dtype=torch.int64,
                       device=rs.device)
    for p in range(plan.n_packs):
        for t in range(p * bpp, (p + 1) * bpp):
            bm_a = _branch_metrics(rs[t, 0], rs[t, 1], s0, s1, is_float)
            pm, pp = _acs_stage(pm, pp, bm_a)
        surv[p] = pp & ((1 << bpp) - 1)
        if renorm:
            # once per pack, as the kernels do (decision-invariant)
            pm = pm - pm.min(dim=0, keepdim=True).values
    return surv


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


def decode_blocks_torch(packed: torch.Tensor, cfg: DecoderConfig,
                        plan: BlockPlan) -> torch.Tensor:
    """Packed channel words -> (B, n_emit) int32 output packs: the plain
    version of K1 (core_cuda.K1), same inputs, same outputs."""
    is_float = cfg.channel_in == ChannelIn.FP32
    packed = packed.to(torch.float32 if is_float else torch.int32)
    rs = stage_values(packed, cfg, plan)
    surv = forward_scan(rs, cfg, plan)
    return to_int32_bits(traceback_scan(surv, cfg, plan))


def decode_packed_torch(packed: torch.Tensor, cfg: DecoderConfig,
                        plan: BlockPlan) -> torch.Tensor:
    """Full decode straight from packed channel words (the
    ViterbiCUDA::run input format, viterbi.cu:211-238) -> flat int32
    packed output words.  Counterpart of ``decode_packed_xla``."""
    return assemble_output(decode_blocks_torch(packed, cfg, plan), cfg, plan)
