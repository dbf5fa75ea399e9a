"""In-graph simulation traffic: ``simulate(seed)`` of the program's
``build_sharded_simulation`` called back to back, a fresh seed a call drawn
from ``--seed`` and the call's index, each call's bit-error count read to
the host as a BER sweep reads it.  ``sim_gbps`` is the decoded bits of
every call of the window over its seconds.

A sample of the window's calls, drawn from the seed, is held to the
reference: it re-draws the call's message and channel words from the
streams' definition (``reference_stream``), decodes them, and counts.  The
program's decoded words are compared bit for bit with the reference's
decode, and its count with the errors of its own words against the
re-drawn message.
"""

from __future__ import annotations

import random

from .. import program, reference
from .. import reference_stream as rs
from ..harness import (Check, Outcome, Reservoir, closed_loop, derive, free,
                       memory_peak_bytes, read_trace, shape)


def reference_call(cell, seed: int, device, control: str = None):
    """The reference's call: -> (bit-error count, decoded words, message
    packs) of the message and words that ``seed`` draws; with ``control``,
    decoded a step below the configuration's precision."""
    config, traffic = cell.config, cell.traffic
    channel, plan = shape(cell)
    packs, words = rs.stream((0, seed), traffic["message_bits"], channel,
                             traffic["snr_db"], config["scale"], device)
    out = (reference.control_decode([words], channel, plan, control)
           if control else reference.decode([words], channel, plan))[0]
    truth = rs.to_int32(rs.reference_words(packs, plan.message_len,
                                           plan.bits_per_pack))
    return reference.differing_bits(out, truth), out, packs


def control(cell, device):
    """The reference a step below the configuration's precision, as
    ``simulate``."""
    def simulate(seed):
        ben, out, _ = reference_call(cell, seed, device,
                                     cell.config["control"])
        return ben, out
    return simulate


def run(cell, ctx) -> Outcome:
    traffic = cell.traffic
    channel, plan = shape(cell)
    ctx.mark("imports")
    if ctx.program:
        simulate = ctx.program(cell, ctx.device)
    else:
        simulate, m = program.simulation(cell.config, traffic, ctx.device)
        if m != plan.message_len:
            raise RuntimeError(f"the program decodes {m} bits a call, the "
                               f"framing {plan.message_len}")
    ctx.mark("program")
    for i in range(traffic["warmup_calls"]):
        int(simulate(derive(ctx.seed, "warm", i))[0])
    ctx.mark("warm-up")
    sample = Reservoir(traffic["sample"],
                       random.Random(derive(ctx.seed, "sample")))

    def call(i):
        seed = derive(ctx.seed, "sim", i)
        ben, out = simulate(seed)
        sample.offer((seed, int(ben), out))

    window = closed_loop(call, ctx, traffic["trace_calls"],
                         traffic["warmup_calls"])
    peak = memory_peak_bytes(ctx.device)
    del simulate
    free(ctx.device)

    def check():
        decode_diff = count_gap = 0
        for seed, ben, out in sample.items:
            _, ref_out, packs = reference_call(cell, seed, ctx.device)
            decode_diff += reference.differing_bits(out, ref_out)
            truth = rs.to_int32(rs.reference_words(
                packs, plan.message_len, plan.bits_per_pack))
            count_gap += abs(ben - reference.differing_bits(out, truth))
        return [Check("decoded_bits_differing", decode_diff, 0),
                Check("count_gap", count_gap, 0)]

    return Outcome(
        attempted=window.calls,
        end_to_end={"setup_s": window.start - ctx.start,
                    "sim_gbps": window.calls * plan.message_len
                    / window.seconds / 1e9},
        shapes={"channel": channel, "plan": plan,
                "noisy": rs.sigma_of(traffic["snr_db"]) > 0,
                "sampled": len(sample.items)},
        memory_peak_bytes=peak, check=check, window=window,
        trace=read_trace(window))
