"""The FP32 channel's two decode routes on the card: K27, the counterpart of
``scripts/fp32_fused_value_probe.py``, which asked on the TPU whether a
fused value kernel on the raw f32 wire (clamp, u/d and trunc in the
kernel) beats the shipped u/d-word route.  K27 is no kernel of its own:
its routes are launches of K2, K3 and K1's ``ud`` reader.

    python -m tpu_viterbi_torch.scripts.fp32_fused_value_probe [bits]

Routes (the JAX script's, :176-201):
  fused value    K2 on the raw wire, ``dec_len`` 2048, full store, and K3's
                 float reader at 4096 with the windowed survivor (the JAX
                 kernel's VMEM limits: 2048 full and 4096 windowed fit)
  u/d words      ``fp32_ud_words_torch`` stages the wire into SOFT8-framed
                 (u, d) words, K1's ``ud`` reader decodes them at 8192 (the
                 route the JAX package ships); also timed apart: the
                 staging alone, K1-``ud`` alone at 8192 and at 2048
First the JAX script's check (:133-149): both routes bit-equal at 2M bits,
full store on both sides, on ``standard_normal x 5`` values from numpy's
generator seeded 3 (and K3 float against K3 ``ud`` at 4096 windowed).
Then each route on ``normal x 4`` values (JAX :153) at ``bits``: ms, ns per
stage per 128-block tile (the JAX unit) and decoded Gb/s, each the median
of RUNS CUDA-event calls after one untimed call.  A route's call is its
whole decode, output assembled.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import hardware
from ..config import ChannelIn, DecoderConfig
from ..decoder import core_cuda
from ..decoder.core_torch import BlockPlan, fp32_ud_words_torch, plan_blocks
from .common import stage_tiles, timed

N_BITS = 32_000_000
CHECK_BITS = 2_000_000
CFG = DecoderConfig(ChannelIn.FP32)
RUNS = 5
# (label, dec_len, window, route): "value" K2/K3 on the wire, "ud" the
# u/d words (staging + K1-ud), "staging" the u/d staging alone, "ud-kernel"
# K1-ud on staged words
ROUTES = (("fused-value dl=4096 win=True (K3)", 4096, True, "value"),
          ("fused-value dl=2048 win=False (K2)", 2048, False, "value"),
          ("shipped ud-words dl=8192 (K1-ud)", 8192, False, "ud"),
          ("ud staging alone", 8192, False, "staging"),
          ("K1-ud alone dl=8192", 8192, False, "ud-kernel"),
          ("K1-ud alone dl=2048", 2048, False, "ud-kernel"))


def make_plan(n: int, dec_len: int) -> BlockPlan:
    return plan_blocks(CFG.get_message_len(2 * n), 32, dec_len)


def check_values(n: int, device) -> torch.Tensor:
    """The check's wire: 4n values standard_normal x 5 from numpy's
    generator seeded 3 (JAX :139-140)."""
    v = np.random.default_rng(3).standard_normal(4 * n) * 5
    return torch.from_numpy(v.astype(np.float32)).to(device)


def wire(n: int, device, seed: int = 0) -> torch.Tensor:
    """A timing wire: the channel's input words of n bits, N(0, 16) values
    from a torch.Generator on ``device`` (JAX :152-153)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(CFG.get_input_words(2 * n), generator=gen,
                       device=device) * 4


def route(kind: str, x: torch.Tensor, plan: BlockPlan, window: bool,
          udw: torch.Tensor = None):
    """A call of one route on the wire x (``udw``: x's staged u/d words, for
    "ud-kernel")."""
    if kind == "value":
        return lambda: core_cuda.decode_packed_cuda(x, CFG, plan,
                                                    window=window)
    if kind == "ud":
        return lambda: core_cuda.decode_ud_words_cuda(
            fp32_ud_words_torch(x), CFG, plan, window)
    if kind == "staging":
        return lambda: fp32_ud_words_torch(x)
    return lambda: core_cuda.decode_ud_words_cuda(udw, CFG, plan, window)


def check(n: int = CHECK_BITS, device="cuda") -> dict:
    """{"full": the u/d route equals K2 at 2048, full store; "window": K3
    on the u/d words equals K3 on the wire at 4096}, on ``check_values``."""
    x = check_values(n, device)
    udw = fp32_ud_words_torch(x)
    res = {}
    for key, dec_len, window in (("full", 2048, False), ("window", 4096,
                                                         True)):
        plan = make_plan(n, dec_len)
        want = core_cuda.decode_packed_cuda(x, CFG, plan, window=window)
        got = core_cuda.decode_ud_words_cuda(udw, CFG, plan, window)
        res[key] = bool(torch.equal(got, want))
    return res


def probe(n: int = N_BITS, device="cuda") -> dict:
    """The check at CHECK_BITS, then every route at n bits on the card,
    one line each; returns {"check": check's result, label: median ms}."""
    dev = hardware.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the FP32 route probe times kernels on the card")
    res = {"check": check(min(n, CHECK_BITS), dev)}
    same = res["check"]
    print(f"bit-equality vs u/d-word path @{min(n, CHECK_BITS)}: "
          f"{'OK' if same['full'] else 'MISMATCH'} (full store, dec_len "
          f"2048); window 4096: {'OK' if same['window'] else 'MISMATCH'}",
          flush=True)
    x = wire(n, dev)
    udw = fp32_ud_words_torch(x)
    m = CFG.get_message_len(2 * n)
    print(f"{torch.cuda.get_device_name(dev)}: {m} bits, {x.numel()} f32 "
          f"values ({x.numel() * 4 / 1e6:.1f} MB), {udw.numel()} u/d words",
          flush=True)
    for label, dec_len, window, kind in ROUTES:
        plan = make_plan(n, dec_len)
        ms, all_ms, _ = timed(route(kind, x, plan, window, udw), RUNS)
        stages = stage_tiles(plan)
        rate = "" if kind == "staging" else (
            f" ({ms * 1e6 / stages:6.3f} ns/stage, {m / ms / 1e6:.3f} Gb/s)")
        print(f"{label:36s} {ms:8.4f} ms{rate} of "
              f"{[round(t, 4) for t in all_ms]}", flush=True)
        res[label] = ms
    return res


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    res = probe(int(argv[0]) if argv else N_BITS)
    return 0 if all(res["check"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
