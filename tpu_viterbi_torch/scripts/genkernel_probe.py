"""The generator probe on the card: kernel K20, the counterpart of
``scripts/genkernel_probe.py``, which asked whether a TPU kernel could run
the fused generator's pieces (threefry2x32 in int32 vector ops, f32 log and
sqrt) and how fast it drew.

    python -m tpu_viterbi_torch.scripts.genkernel_probe [--device cpu]

Three entries of one kernel (``csrc/genkernel_probe.cu``), each against its
plain PyTorch version:
  tf        threefry2x32 at 20 rounds on the JAX probe's (2, 8, 128)
            counters (c0 = 0 .. 1023, c1 = 7) under key 0xDEADBEEF /
            0x12345678: parity, bit for bit, and the known answers of
            Random123's threefry2x32_20 vectors (jax's own values)
  log_sqrt  log(x) + sqrt(x) on (8, 128) f32 from linspace(0.01, 9): the
            max rel err against float64 numpy, and ulps against torch
            (``term_ulps``: ulps of the larger term, as the terms cancel
            near x = 0.49)
  many      the XOR of reps in {4, 8} threefry calls on counters (c0 + r,
            c1) over the JAX grid G x RB x L = 64 x 256 x 128 counter pairs
            (c0 = the row, c1 = 3, key 1 / 2), at 20 rounds (the JAX
            probe's) and 13 (K7's ``kGenRounds``: the rate that bounds K7)
A ``many`` time is read two ways after an untimed launch: CUDA events
around LAUNCHES_A_SAMPLE launches queued from Python, divided by their
number (the best and the median of REPS such samples), and the median of
REPS replays of a CUDA graph of GRAPH_CALLS launches over their number
(``utils.timing.graph_ms``).  The queued samples include the host's
``ctypes`` launch of each call; the graph replay reads the card's own
launch and run, and its rate is the one that prices K7's and K8's draws.
Each line gives both, threefry calls a ns and ns a call.  The threefry is
K7's own (``csrc/threefry.cuh``).

With ``--device cpu`` only the parity parts run, on the plain versions (the
known answers and the rel err); the rates need the card.
"""

from __future__ import annotations

import ctypes
import statistics
import sys

import numpy as np
import torch

from .. import hardware
from ..chain.genkernel import GEN_ROUNDS, M32, threefry2x32
from ..utils.bits import to_int32_bits
from .common import ProbeKernel

ROUNDS = 20                     # the JAX probe's (and jax's threefry_2x32)
ROUNDS_LIST = (ROUNDS, GEN_ROUNDS)
R, L = 8, 128                   # the parity shape (genkernel_probe.py:45)
KEY = (0xDEADBEEF, 0x12345678)
G, RB = 64, 256                 # the rate grid (:96)
MANY_KEY = (1, 2)
REPS_LIST = (4, 8)
REPS = 5                        # CUDA-event samples of `many`, each of
# LAUNCHES_A_SAMPLE launches queued from Python (each sample includes the
# host's launch of each; GRAPH_CALLS leaves it out)
LAUNCHES_A_SAMPLE = 10
GRAPH_CALLS = 100               # launches of `many` a CUDA graph replays
ENTRIES = ("tf", "log_sqrt", "many")
# Random123's threefry2x32_20 known-answer vectors (key, counter, output),
# which jax._src.prng.threefry_2x32 reproduces
KNOWN_ANSWERS = (
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((M32, M32), (M32, M32), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)))


def threefry_ops(rounds: int) -> int:
    """Lane-instructions of one threefry2x32 call: 3 a round (add, funnel
    shift, xor), 2 a key injection (after every 4th round and the last),
    and the counter's 2 key adds: 72 at 20 rounds, 49 at 13."""
    return 3 * rounds + 2 * (-(-rounds // 4) + 1)


MANY_OPS = 3    # a `many` call's counter add and its two XORs


def tf_input(device) -> torch.Tensor:
    """(2, R, L) int32 counters of the JAX probe: c0 = 0 .. R*L - 1, c1 =
    7."""
    c0 = torch.arange(R * L, dtype=torch.int32).reshape(R, L)
    return torch.stack([c0, torch.full((R, L), 7, dtype=torch.int32)]) \
        .to(device)


def log_input(device) -> torch.Tensor:
    """(R, L) f32 values linspace(0.01, 9) of the JAX probe (numpy's)."""
    x = np.linspace(0.01, 9.0, R * L, dtype=np.float32).reshape(R, L)
    return torch.from_numpy(x).to(device)


def many_input(device, g: int = G, rb: int = RB) -> torch.Tensor:
    """(2, g * rb, L) int32 counters of the rate grid: c0 = the row, c1 =
    3."""
    rows = torch.arange(g * rb, dtype=torch.int32, device=device)
    c0 = rows[:, None].expand(g * rb, L)
    return torch.stack([c0, torch.full_like(c0, 3)]).contiguous()


def tf_torch(c: torch.Tensor, k0: int, k1: int, rounds: int = ROUNDS):
    """Plain version of ``tf``: (2, ...) int32 counters -> (x0, x1) int32
    of the counters' shape."""
    x0, x1 = threefry2x32(k0, k1, c[0], c[1], rounds)
    return to_int32_bits(x0), to_int32_bits(x1)


def log_sqrt_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``log_sqrt``."""
    return torch.log(x) + torch.sqrt(x)


def many_torch(c: torch.Tensor, k0: int, k1: int, reps: int,
               rounds: int = ROUNDS) -> torch.Tensor:
    """Plain version of ``many``: the XOR of x0 ^ x1 over reps calls on
    counters (c0 + r, c1), the add wrapping in 32 bits (in int64, masked,
    as threefry2x32 reads its counters) -> int32 of c[0]'s shape."""
    acc = torch.zeros(c.shape[1:], dtype=torch.int64, device=c.device)
    c0 = c[0].to(torch.int64)
    for r in range(reps):
        x0, x1 = threefry2x32(k0, k1, (c0 + r) & M32, c[1], rounds)
        acc = acc ^ x0 ^ x1
    return to_int32_bits(acc)


def _check_counters(c: torch.Tensor) -> None:
    if c.dim() < 2 or c.shape[0] != 2 or c.dtype != torch.int32 or \
            not c.is_contiguous() or c[0].numel() == 0:
        raise ValueError(f"K20 takes contiguous (2, ...) int32 counters, got "
                         f"{c.dtype} {tuple(c.shape)}")


def _check_rounds(rounds: int) -> None:
    if rounds not in ROUNDS_LIST:
        raise ValueError(f"K20 runs {ROUNDS_LIST} rounds, got {rounds}")


class GenProbeKernel(ProbeKernel):
    """K20, bound to ``viterbi_k20_launch``: ``tf``, ``log_sqrt`` and
    ``many``, each one launch on a CUDA tensor (on the current stream, not
    synchronized) and its plain version on a CPU tensor."""

    def __init__(self):
        super().__init__("K20", "viterbi_k20_launch", "genkernel_probe.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                          ctypes.c_uint, ctypes.c_int, ctypes.c_int])

    def tf(self, c: torch.Tensor, k0: int, k1: int, rounds: int = ROUNDS):
        _check_counters(c)
        _check_rounds(rounds)
        if not self.check_device(c):
            return tf_torch(c, k0, k1, rounds)
        o0, o1 = torch.empty_like(c[0]), torch.empty_like(c[0])
        self.launch(c.device, 0, c.data_ptr(), o0.data_ptr(), o1.data_ptr(),
                    o0.numel(), k0 & M32, k1 & M32, 1, rounds)
        return o0, o1

    def log_sqrt(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32 or not x.is_contiguous() or \
                x.numel() == 0:
            raise ValueError(f"K20 log_sqrt takes contiguous float32, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not self.check_device(x):
            return log_sqrt_torch(x)
        out = torch.empty_like(x)
        self.launch(x.device, 1, x.data_ptr(), out.data_ptr(), None,
                    x.numel(), 0, 0, 1, ROUNDS)
        return out

    def many(self, c: torch.Tensor, k0: int, k1: int, reps: int,
             rounds: int = ROUNDS) -> torch.Tensor:
        _check_counters(c)
        _check_rounds(rounds)
        if reps < 1:
            raise ValueError(f"K20 many takes reps >= 1, got {reps}")
        if not self.check_device(c):
            return many_torch(c, k0, k1, reps, rounds)
        out = torch.empty_like(c[0])
        self.launch(c.device, 2, c.data_ptr(), out.data_ptr(), None,
                    out.numel(), k0 & M32, k1 & M32, reps, rounds)
        return out


K20 = GenProbeKernel()


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in ulps of two finite f32 tensors of one sign."""
    return int((a.view(torch.int32).to(torch.int64)
                - b.view(torch.int32).to(torch.int64)).abs().max())


def term_ulps(got: torch.Tensor, want: torch.Tensor,
              x: torch.Tensor) -> float:
    """Largest |got - want| of two log(x) + sqrt(x) results in ulps of the
    larger term, max(|log x|, sqrt x): the measure of a libm ulp.  (Near
    x = 0.49 the two terms cancel, and an ulp of a term is many ulps of
    the sum.)"""
    x64 = x.cpu().to(torch.float64)
    big = torch.maximum(torch.log(x64).abs(), torch.sqrt(x64)) \
        .to(torch.float32)
    ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    diff = (got.cpu().to(torch.float64) - want.cpu().to(torch.float64)).abs()
    return float((diff / ulp.to(torch.float64)).max())


def parity(device) -> dict:
    """The probe's parity parts on ``device``: tf against its plain version
    and the known answers, log_sqrt against float64 numpy and torch.
    Prints the JAX probe's two lines; returns {"tf_ok", "known_ok",
    "rel_err", "ulps"}."""
    c = tf_input(device)
    g0, g1 = K20.tf(c, *KEY)
    w0, w1 = tf_torch(c.cpu(), *KEY)
    ok0 = torch.equal(g0.cpu(), w0)
    ok1 = torch.equal(g1.cpu(), w1)
    print(f"threefry2x32 parity vs the plain version: x0 "
          f"{'OK' if ok0 else 'MISMATCH'}, x1 {'OK' if ok1 else 'MISMATCH'}",
          flush=True)
    kc = torch.tensor([[k[1][0] for k in KNOWN_ANSWERS],
                       [k[1][1] for k in KNOWN_ANSWERS]], dtype=torch.int64)
    known = []
    for (k0, k1), _, want in KNOWN_ANSWERS:
        x0, x1 = K20.tf(to_int32_bits(kc).to(device), k0, k1)
        i = len(known)
        known.append((int(x0[i]) & M32, int(x1[i]) & M32) == want)
    print(f"threefry2x32-20 known answers (Random123): "
          f"{'OK' if all(known) else 'MISMATCH'} ({sum(known)} of "
          f"{len(known)})", flush=True)
    x = log_input(device)
    got = K20.log_sqrt(x)
    x64 = x.cpu().numpy().astype(np.float64)
    want = np.log(x64) + np.sqrt(x64)
    err = float(np.max(np.abs(got.cpu().numpy() - want)
                       / np.maximum(np.abs(want), 1e-3)))
    plain = log_sqrt_torch(x)
    ulps = term_ulps(got, plain, x)
    sum_ulps = ulp_diff(got.cpu(), plain.cpu())
    print(f"log+sqrt in-kernel: max rel err {err:.2e} (against float64 "
          f"numpy); {ulps:g} ulp of the larger term ({sum_ulps} of the sum) "
          f"from torch.log + torch.sqrt", flush=True)
    return dict(tf_ok=ok0 and ok1, known_ok=all(known), rel_err=err,
                ulps=ulps)


def rates(device) -> list:
    """``many`` at the JAX grid for each rounds and reps, read two ways:
    LAUNCHES_A_SAMPLE launches queued from Python between two CUDA events
    (REPS samples) and GRAPH_CALLS launches replayed from one CUDA graph
    (``utils.timing.graph_ms``, REPS replays), which leaves out the host's
    launch; one line each.  Returns [{"rounds", "reps", "calls", "ms",
    "best_ms", "all_ms", "calls_per_ns", "ns_per_call", "graph_ms",
    "graph_all_ms", "graph_calls_per_ns"}], the times a launch (the rates
    from the queued best and the graph median)."""
    from ..utils.timing import cuda_ms, graph_ms
    c = many_input(device)
    out = []
    for rounds in ROUNDS_LIST:
        for reps in REPS_LIST:
            def fn():
                for _ in range(LAUNCHES_A_SAMPLE):
                    K20.many(c, *MANY_KEY, reps, rounds)
            first = K20.many(c, *MANY_KEY, reps, rounds)
            _, sample_ms, _ = cuda_ms(fn, REPS)
            all_ms = [t / LAUNCHES_A_SAMPLE for t in sample_ms]
            ms = statistics.median(all_ms)
            g_ms, g_all, g_out = graph_ms(
                lambda: K20.many(c, *MANY_KEY, reps, rounds), GRAPH_CALLS,
                REPS)
            if not torch.equal(g_out, first):
                raise AssertionError(f"K20 many at {rounds} rounds, reps "
                                     f"{reps}: the graph's result differs")
            calls = G * RB * L * reps
            best = min(all_ms)
            out.append(dict(rounds=rounds, reps=reps, calls=calls, ms=ms,
                            best_ms=best, all_ms=all_ms,
                            calls_per_ns=calls / (best * 1e6),
                            ns_per_call=best * 1e6 / calls, graph_ms=g_ms,
                            graph_all_ms=g_all,
                            graph_calls_per_ns=calls / (g_ms * 1e6)))
            print(f"reps={reps}: best {best:.4f} ms for {calls / 1e6:.1f}M "
                  f"threefry calls ({rounds} rounds; median {ms:.4f} ms of "
                  f"{[round(t, 4) for t in all_ms]}, queued) = "
                  f"{calls / (best * 1e6):.1f} calls/ns, "
                  f"{best * 1e6 / calls:.6f} ns a call at the {G} x {RB} x "
                  f"{L} grid; replayed from a graph of {GRAPH_CALLS}: "
                  f"{g_ms:.4f} ms of {[round(t, 4) for t in g_all]} = "
                  f"{calls / (g_ms * 1e6):.1f} calls/ns", flush=True)
    return out


def probe(device="cuda") -> dict:
    """The parity parts, and on the card the rates: {"parity": ...,
    "rates": [...]}."""
    dev = hardware.resolve_device(device)
    res = {"parity": parity(dev), "rates": []}
    if not (res["parity"]["tf_ok"] and res["parity"]["known_ok"]):
        raise AssertionError("K20's threefry disagrees with its plain "
                             "version or the known answers")
    if dev.type == "cuda":
        print(f"{torch.cuda.get_device_name(dev)}: threefry rates "
              f"({ROUNDS} rounds: the JAX probe's; {GEN_ROUNDS}: K7's)",
              flush=True)
        res["rates"] = rates(dev)
    return res


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if argv[:1] == ["--device"] and len(argv) == 2:
        device = argv[1]
    elif argv:
        raise SystemExit("usage: python -m tpu_viterbi_torch.scripts."
                         "genkernel_probe [--device cpu]")
    probe(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
