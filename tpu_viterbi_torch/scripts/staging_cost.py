"""What staging costs a decode on the card: the counterpart of
``scripts/staging_cost.py``, which split the TPU's full SOFT8 decode at 32M
bits (dec_len 8192) into the kernel on pre-staged input, the in-graph
staging around it, and the assemble and check after it, and tried two ways
to stage nothing (views, and an in-kernel roll halo).  With kernel K23, the
roll-halo decode (``csrc/staging_cost.cu``).

    python -m tpu_viterbi_torch.scripts.staging_cost [message_bits]

Variants, each timed with CUDA events, one warmed launch a sample
(``common.time_piece``), on random full-range SOFT8 words:
  pre     K4 in word mode on words K6 staged beforehand, plan0 (the plan of
          (B - 1) * dec_len bits: overlap_bits 0, the JAX "no patch" plan)
  roll    K23 on the stream pre-padded to ``need`` words: bodies from
          device memory, halos from the next block of the 128-block tile
          through shared memory, the tile's last block wrapping to its
          first (``_kernel_roll``'s pltpu.roll: a timing probe); each
          block over ``lanes`` threads (``common.LANES``, a tile a cluster
          of 8 CUDA blocks when split, the halo through distributed shared
          memory), timed at every lane count in turn with one lane
          (``common.TURNS``), the pick (``common.lanes_for`` of the
          blocks) the variant's time
  views   K1 on that pre-padded stream: K1 reads each block's body and
          halo straight from the flat stream, its own zero-copy design
  graphP  K6 + K4 on the pre-padded stream (the JAX no-concat path)
  graph   K6 + K4 on the live stream
  graph0  K6 + K4 on the live stream under plan0
  full    decode_packed_cuda (K1 + assemble) and a popcount of its words
  full0   the same under plan0
On the GPU there is no last-block patch and no pad-concat (K6 and K1 read
zero past a stream's end), so the first two attribution lines measure
K6 + K4's own differences; the line ``views - pre`` says what reading the
flat stream costs K1 against pre-staged coalesced words, and ``roll -
views`` what K23 at its pick differs by from K1: the shared-memory halo,
but also K23's int32 metrics against K1's int16x2 and its lanes against
K1's one.
"""

from __future__ import annotations

import ctypes
import sys
from dataclasses import replace

import torch

from .. import hardware
from ..config import ChannelIn, ConfigResolutionError, DecoderConfig
from ..decoder import core_cuda
from ..decoder.core_torch import (BlockPlan, block_major_words,
                                  decode_staged_torch, needs_int32_renorm,
                                  plan_blocks, traceback_shape,
                                  words_per_block)
from ..utils.bits import _popcount32
from .common import (LANES, LT, TURNS, LaneKernel, innermost_loops,
                     loop_stages, print_attribution, sass_table, shfl_count,
                     stage_tiles, time_piece)

N_BITS = 32_000_000
DEC_LEN = 8192
CFG = DecoderConfig(ChannelIn.SOFT8)
VARIANTS = ("pre", "roll", "views", "graphP", "graph", "graph0", "full",
            "full0")                 # the JAX script's order (:263-270)


def padded_blocks(plan: BlockPlan) -> int:
    """b_pad: the plan's blocks rounded up to whole 128-block tiles."""
    return -(-plan.num_blocks // LT) * LT


def padded_plan(plan: BlockPlan) -> BlockPlan:
    """The plan over all b_pad blocks (what the roll kernel decodes)."""
    b_pad = padded_blocks(plan)
    return replace(plan, num_blocks=b_pad,
                   message_len=b_pad * plan.dec_len)


def need_words(cfg: DecoderConfig, plan: BlockPlan) -> int:
    """The pre-padded stream's words, b_pad * wpb + wpb + wph (JAX
    :160-162)."""
    wpb, wph = words_per_block(cfg, plan)
    return padded_blocks(plan) * wpb + wpb + wph


def _check(packed: torch.Tensor, cfg: DecoderConfig, plan: BlockPlan):
    if cfg.channel_in != ChannelIn.SOFT8 or plan.bits_per_pack != 32:
        raise ConfigResolutionError(
            f"K23 decodes the probe's SOFT8 channel in b32 packs, not "
            f"{cfg.channel_in.name} b{plan.bits_per_pack}")
    wpb, wph = words_per_block(cfg, plan)
    if wph > wpb:
        raise ValueError(f"the roll halo lies in the next block: dec_len "
                         f"{plan.dec_len} < 64 has wph {wph} > wpb {wpb}")
    if needs_int32_renorm(cfg, plan):
        raise ValueError(f"K23 does not renormalise: dec_len "
                         f"{plan.dec_len} is too long for int32 metrics")
    if packed.dtype != torch.int32 or packed.dim() != 1 or \
            not packed.is_contiguous():
        raise ValueError(f"K23 takes a contiguous 1-D int32 stream, got "
                         f"{packed.dtype} {tuple(packed.shape)}")


def roll_words(packed: torch.Tensor, cfg: DecoderConfig,
               plan: BlockPlan) -> torch.Tensor:
    """(Lw, b_pad) word-major words of ``_kernel_roll`` (:219-229): block
    128q + l's body, then the first wph words of block 128q + (l + 1) % 128
    (the tile wraps)."""
    _check(packed, cfg, plan)
    b_pad = padded_blocks(plan)
    _, wph = words_per_block(cfg, plan)
    body, _ = block_major_words(packed, cfg, plan, b_pad)
    lane = torch.arange(b_pad, device=packed.device)
    nbr = lane - lane % LT + (lane + 1) % LT
    return torch.cat([body, body[nbr, :wph]], dim=1).t().contiguous()


def roll_decode_torch(packed: torch.Tensor, cfg: DecoderConfig,
                      plan: BlockPlan) -> torch.Tensor:
    """Plain version of K23: the staged decode (K4's plain version, full
    store) of ``roll_words`` -> (b_pad, n_emit) int32 packs."""
    return decode_staged_torch(roll_words(packed, cfg, plan), cfg,
                               padded_plan(plan))


class RollKernel(LaneKernel):
    """K23, bound to ``viterbi_k23_launch``."""

    def __init__(self):
        super().__init__("K23", "viterbi_k23_launch", "staging_cost.cu",
                         [ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_void_p, ctypes.c_void_p,
                          *[ctypes.c_int] * 7])

    def __call__(self, packed: torch.Tensor, cfg: DecoderConfig,
                 plan: BlockPlan, lanes: int = None) -> torch.Tensor:
        """(b_pad, n_emit) int32 packs (uint32 bit patterns).  On a CUDA
        tensor one launch on the current stream, not synchronized, each
        block over ``lanes`` lanes (``lanes_for`` the b_pad blocks when
        None); on a CPU tensor its plain version."""
        _check(packed, cfg, plan)
        lanes = self.pick_lanes(padded_blocks(plan), lanes)
        if not self.check_device(packed):
            return roll_decode_torch(packed, cfg, plan)
        pplan = padded_plan(plan)
        b_pad = pplan.num_blocks
        n_conv, n_emit = traceback_shape(cfg, pplan)
        wpb, wph = words_per_block(cfg, pplan)
        surv = torch.empty((pplan.n_packs, 64, b_pad), dtype=torch.int32,
                           device=packed.device)
        out = torch.empty((b_pad, n_emit), dtype=torch.int32,
                          device=packed.device)
        self.launch_lanes(packed.device, lanes, packed.data_ptr(),
                          packed.numel(), surv.data_ptr(), out.data_ptr(),
                          b_pad, wpb, wph, pplan.n_packs, n_conv, n_emit,
                          lanes)
        return out


K23 = RollKernel()


def body_pass_loop(spans):
    """K23's stage loop among a kernel's ``loop_spans``: the first of its
    longest innermost loops (within a quarter of the longest).  At one lane
    that is the stage loop; split, the loop of the body's passes, which the
    loop of the last few passes, those that read the halo, follows."""
    inner = innermost_loops(spans)
    most = max(n for _, _, n in inner)
    return min((span for span in inner if 4 * span[2] >= 3 * most),
               key=lambda span: span[0])


def sass_counts() -> dict:
    """{lanes: (SASS instructions of K23's stage loop (``body_pass_loop``),
    {REG, STACK, ...}, the loop's opcode mix)} read from the built
    library."""
    return sass_table("viterbi_roll", {
        n: ("roll_kernel",) if n == 1 else ("roll_lanes_kernel", f"ILi{n}E")
        for n in LANES}, body_pass_loop)


def popcount_sum(out: torch.Tensor) -> torch.Tensor:
    """The set bits of int32 words (the JAX probe's full-decode consumer):
    a 0-dim int64 tensor."""
    return _popcount32(out.to(torch.int64) & 0xFFFFFFFF).sum()


def make_plans(n: int, dec_len: int = DEC_LEN, cfg: DecoderConfig = CFG):
    """(plan, plan0): the n-bit transmission's plan, and plan0 of (B - 1) *
    dec_len bits, whose overlap_bits is 0 (JAX :56-60)."""
    plan = plan_blocks(cfg.get_message_len(2 * n), cfg.bits_per_pack,
                       dec_len)
    m0 = (plan.num_blocks - 1) * dec_len
    plan0 = plan_blocks(m0, cfg.bits_per_pack, dec_len)
    if plan0.overlap_bits != 0:
        raise AssertionError(f"plan0 has overlap_bits {plan0.overlap_bits}")
    return plan, plan0


def make_inputs(n: int, device, dec_len: int = DEC_LEN,
                cfg: DecoderConfig = CFG, seed: int = 0) -> dict:
    """The probe's inputs: x, the transmission's n_words random words; xp,
    need_words random words; st0, x staged for plan0 (K6, or its plain
    version on the CPU); the two plans."""
    plan, plan0 = make_plans(n, dec_len, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def words(k):
        return torch.randint(-2 ** 31, 2 ** 31, (k,), generator=gen,
                             device=device, dtype=torch.int64
                             ).to(torch.int32)

    x = words(cfg.get_input_words(2 * n))
    xp = words(need_words(cfg, plan))
    st0 = core_cuda.stage_words_cuda(x, cfg, plan0)
    return dict(x=x, xp=xp, st0=st0, plan=plan, plan0=plan0)


def variants(inp: dict, cfg: DecoderConfig = CFG) -> dict:
    """{variant: a call of it on ``inp``} (``make_inputs``); roll's takes
    K23's lanes (None: the pick)."""
    x, xp, st0 = inp["x"], inp["xp"], inp["st0"]
    plan, plan0 = inp["plan"], inp["plan0"]
    K1, K4 = core_cuda.K1, core_cuda.K4
    stage = core_cuda.stage_words_cuda
    return {
        "pre": lambda: K4(st0, cfg, plan0),
        "roll": lambda lanes=None: K23(xp, cfg, plan, lanes),
        "views": lambda: K1(xp, cfg, plan),
        "graphP": lambda: K4(stage(xp, cfg, plan), cfg, plan),
        "graph": lambda: K4(stage(x, cfg, plan), cfg, plan),
        "graph0": lambda: K4(stage(x, cfg, plan0), cfg, plan0),
        "full": lambda: popcount_sum(core_cuda.decode_packed_cuda(x, cfg,
                                                                  plan)),
        "full0": lambda: popcount_sum(core_cuda.decode_packed_cuda(x, cfg,
                                                                   plan0)),
    }


def time_roll(roll, plan: BlockPlan, lanes) -> list:
    """``roll`` (``variants``' K23 call on the plan's words) at each lane
    count of ``lanes`` in turn (``time_piece``, one line each, with the
    SASS and SHFL of its stage loop a stage and its registers): [{lanes,
    ms, picked, sass_per_stage, shfl_per_stage, regs, stack}]."""
    sass = sass_counts()
    pick = K23.pick_lanes(padded_blocks(plan), None)
    rows = []
    for n in lanes:
        loop, res, mix = sass[n]
        per = loop_stages(n)
        r = dict(lanes=n, picked=n == pick, sass_per_stage=loop / per,
                 shfl_per_stage=shfl_count(mix) / per, regs=res.get("REG"),
                 stack=res.get("STACK"))
        r["ms"] = time_piece(
            f"roll {n:2d} lanes{' (pick)' if r['picked'] else ''}",
            lambda: roll(n), stage_tiles(plan))
        print(f"{'':28s} SASS {r['sass_per_stage']:g}, SHFL "
              f"{r['shfl_per_stage']:g} a stage; registers {r['regs']}, "
              f"stack {r['stack']} B", flush=True)
        rows.append(r)
    return rows


def probe(n: int = N_BITS, device="cuda") -> dict:
    """Time every variant at n bits on the card (roll at each lane count in
    turn with one lane, ``common.TURNS``, its time the pick's first) and
    print the JAX probe's attribution block plus the GPU's lines; returns
    {"ms": {variant: median ms}, "roll": ``time_roll``'s rows}."""
    dev = hardware.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the staging-cost probe times kernels on the card")
    inp = make_inputs(n, dev)
    plan, plan0 = inp["plan"], inp["plan0"]
    print(f"{torch.cuda.get_device_name(dev)}: m={plan.message_len} (ov="
          f"{plan.overlap_bits}) m0={plan0.message_len} (ov=0) dec_len "
          f"{plan.dec_len}: {plan.num_blocks} blocks, b_pad "
          f"{padded_blocks(plan)}; K1 and K4 {core_cuda.K_THREADS} threads a "
          f"CUDA block, K23 {LT} at one lane, else a cluster of 8 CUDA "
          f"blocks a tile", flush=True)
    fns = variants(inp)
    t, rows = {}, []
    for v in VARIANTS:
        if v == "roll":
            rows = time_roll(fns[v], plan, TURNS)
            t[v] = next(r for r in rows if r["picked"])["ms"]
            continue
        zero = v in ("pre", "graph0", "full0")
        t[v] = time_piece(v, fns[v], stage_tiles(plan0 if zero else plan))
    print_attribution([
        ("patch copy (graph-graph0)", t["graph"] - t["graph0"],
         "   (no patch on the GPU: B vs B - 1 blocks)"),
        ("pad-concat (graph-graphP)", t["graph"] - t["graphP"],
         "   (no concat on the GPU: K6 reads zero past the end)"),
        ("halo+input (graphP-pre)", t["graphP"] - t["pre"], ""),
        ("assemble+check (full-graph)", t["full"] - t["graph"], ""),
        ("full0 vs full", t["full"] - t["full0"], ""),
        ("staging for K1 (views-pre)", t["views"] - t["pre"],
         "   (K1's flat-stream reads against K4 on staged words)"),
        ("roll halo (roll-views)", t["roll"] - t["views"],
         f"   (K23 at its pick, {K23.pick_lanes(padded_blocks(plan), None)}"
         f" lanes and int32 metrics, its halo through shared memory, "
         f"against K1's flat-stream halo, int16x2 metrics, one lane)")])
    return {"ms": t, "roll": rows}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    probe(int(argv[0]) if argv else N_BITS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
