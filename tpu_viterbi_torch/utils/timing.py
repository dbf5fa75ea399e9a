"""Kernel timing on the card, and the fixed-shape canary K10; the
counterpart of ``tpu_viterbi/utils/timing.py``.

The JAX package timed by the slope between k and 1 repetitions inside one
jitted graph, each on a fresh input, because its TPU sat behind a relay
that added ~30 ms a call and memoized identical calls (its :1-9).  Here two
CUDA events around the launches read the device's own clock, so one
warmed launch is one sample: no slope and no fresh inputs.  The sweeps
keep JAX's slope only for K calls queued back to back (``queued_s``),
beside their replay from a CUDA graph (``graph_ms``).  Every timing here
needs a CUDA device and raises without one.
"""

from __future__ import annotations

import math
import statistics
from typing import Callable

import torch

from ..config import ChannelIn, DecoderConfig
from ..decoder import core_cuda
from ..decoder.core_torch import BlockPlan, plan_blocks, words_per_block
from ..hardware import resolve_device

LANE_TILE = 128       # blocks per TPU program: the canary's unit of blocks
CANARY_SEED = 7000    # the JAX canary's first key, PRNGKey(7000)


def cuda_ms(fn: Callable, runs: int):
    """CUDA-event times of ``runs`` calls of fn on the current stream, each
    synchronized: (median ms, all ms, the last call's result)."""
    ts = []
    out = None
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts), ts, out


def turns_ms(fns, runs: int):
    """CUDA-event times of the calls ``fns``, launched in turns (a, b, c,
    c, b, a, ...): ([median ms of each], [all ms of each], [the last
    result of each])."""
    ts = [[] for _ in fns]
    outs = [None] * len(fns)
    for i in range(runs):
        order = range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))
        for k in order:
            ms, _, outs[k] = cuda_ms(fns[k], 1)
            ts[k].append(ms)
    return [statistics.median(t) for t in ts], ts, outs


def ab_ms(fa: Callable, fb: Callable, runs: int):
    """CUDA-event times of fa and fb, launched in turns (a, b, b, a, ...):
    (median a, median b, all a, all b, out a, out b)."""
    (ma, mb), (ta, tb), (out_a, out_b) = turns_ms((fa, fb), runs)
    return ma, mb, ta, tb, out_a, out_b


class GraphCaptureError(RuntimeError):
    """``graph_ms`` could not capture the calls into a CUDA graph: a
    launch off the current stream, a synchronizing or allocating call
    that capture refuses.  A fault at replay is not one."""


def graph_ms(fn: Callable, calls: int, runs: int):
    """Device time of one call of fn without the host's share: ``calls``
    calls captured into one CUDA graph, one untimed replay, then the
    CUDA-event times of ``runs`` replays over ``calls``: (median ms a call,
    all ms a call, the last call's result).  A single event-timed launch
    of a microsecond kernel reads the host's dispatch; this reads the
    card's own launch and run.  The calls run on the capture stream and
    their wrappers count each launch once, at capture.  A RuntimeError
    while capturing raises GraphCaptureError; one at replay, itself."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                out = fn()
    except RuntimeError as e:
        raise GraphCaptureError(f"capture failed: {e}") from e
    graph.replay()
    ms, all_ms, _ = cuda_ms(graph.replay, runs)
    return ms / calls, [t / calls for t in all_ms], out


def queued_s(call: Callable, inputs, k: int, reps: int = 3) -> float:
    """Seconds a call of ``call`` from the slope of queued calls: the
    counterpart of the JAX scripts' ``amplified_slope``
    (scripts/timing_util.py:15).  After one untimed call, each of ``reps``
    rounds times 1 and then ``k`` calls queued between two CUDA events on
    the current stream, no synchronize between them, call j of round r on
    ``inputs[(r + 1 + j) % len(inputs)]``, so consecutive calls read
    different words; returns (min t_k - min t_1) / (k - 1), not clamped
    (callers flag a slope <= 0, as JAX's do).

    The slope cancels the events' and the first launch's fixed cost, as
    JAX's cancelled its relay's dispatch floor; it keeps the host's
    launch of each call, so where the host launches a call more slowly
    than the card runs it, the card waits and the slope reads the host
    (``graph_ms`` reads the card's own time).  A CPU tensor raises: there
    is no device clock to read."""
    x = inputs[0]
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"queued_s times CUDA launches and takes CUDA "
                         f"tensors, got "
                         f"{getattr(x, 'device', type(x).__name__)}")
    if k < 2:
        raise ValueError(f"queued_s needs k >= 2 calls, got {k}")
    n = len(inputs)
    with torch.cuda.device(x.device):
        call(x)
        best = {}
        for r in range(reps):
            for kk in (1, k):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                for j in range(kk):
                    call(inputs[(r + 1 + j) % n])
                e.record()
                e.synchronize()
                best[kk] = min(best.get(kk, math.inf), s.elapsed_time(e))
    return (best[k] - best[1]) / (k - 1) / 1e3


def time_in_graph(fn: Callable, x: torch.Tensor, runs: int = 5) -> float:
    """Seconds per fn(x): the median of ``runs`` CUDA-event timed calls
    after one untimed call, on the current stream of x's device.  A CPU
    tensor raises: there is no device clock to read."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"time_in_graph times CUDA launches and takes a "
                         f"CUDA tensor, got "
                         f"{getattr(x, 'device', type(x).__name__)}")
    with torch.cuda.device(x.device):
        fn(x)
        ms, _, _ = cuda_ms(lambda: fn(x), runs)
    return ms / 1e3


def canary_plan(tiles: int = 16, n_packs: int = 256):
    """(cfg, plan) of the canary: SOFT8, b32 packs, ``tiles`` x 128 blocks
    of ``n_packs`` packs each, so dec_len = 32 n_packs - 64 (8128 at the
    default), n_conv 1, n_emit n_packs - 2 and 16 n_packs words a block,
    the static arguments of the JAX canary (bench.py:73-77)."""
    cfg = DecoderConfig(ChannelIn.SOFT8)
    bpp = cfg.bits_per_pack
    dec_len = bpp * n_packs - 64
    plan = plan_blocks(tiles * LANE_TILE * dec_len, bpp, dec_len)
    return cfg, plan


def canary_words(cfg: DecoderConfig, plan: BlockPlan, device="cuda",
                 seed: int = CANARY_SEED) -> torch.Tensor:
    """The canary's pre-staged word-major input: (wpb + wph, B) full-range
    random int32 SOFT8 words from a torch.Generator seeded with ``seed`` on
    ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lw = sum(words_per_block(cfg, plan))
    return torch.randint(-2 ** 31, 2 ** 31, (lw, plan.num_blocks),
                         generator=gen, device=dev, dtype=torch.int64
                         ).to(torch.int32)


def canary_ns(tiles: int = 16, n_packs: int = 256, reps: int = 5,
              device="cuda") -> float:
    """Kernel K10, the counterpart of the JAX bench's ``_run_canary``
    (bench.py:58-109): a fixed-shape launch of K4 in word mode with the
    full survivor store and traceback, on pre-staged random words drawn
    outside the timed region.  Returns ns per ACS stage per 128-block
    tile (the JAX normalisation, bench.py:109): the median launch time
    over tiles x n_packs x 32 stages.

    A fixed shape is the point of a canary, so the JAX shape is kept,
    though on this card it is small: 2048 blocks are 2048 threads, 32 CUDA
    blocks of 64 on 32 of the H100's 132 SMs.  The number measures
    per-thread ACS latency, not the card's throughput."""
    cfg, plan = canary_plan(tiles, n_packs)
    words = canary_words(cfg, plan, device)
    seconds = time_in_graph(lambda w: core_cuda.K4(w, cfg, plan), words,
                            runs=reps)
    return seconds * 1e9 / (tiles * n_packs * plan.bits_per_pack)
