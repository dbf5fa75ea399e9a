"""Receiver traffic: channel words already on the card, decoded one message
at a time through ``ViterbiGPU.run_on_device``, closed loop, one message in
flight.

Set-up makes a ring of distinct messages on the card from ``--seed``
(``reference_stream.stream``, a key a message) and warms the decoder on
them; the window takes messages from the ring in turn.  ``decode_gbps`` is
the decoded bits of every message of the window over its seconds;
``decode_p95_ms`` the 95th percentile of every call's host-clock time, from
the call into ``run_on_device`` to its return, which waits for the decode
on the card.  A sample of the window's answers, drawn from the seed, is
held bit for bit to the reference's decode of its message.
"""

from __future__ import annotations

import random

import numpy as np

from .. import program, reference
from .. import reference_stream as rs
from ..harness import (Check, Outcome, Reservoir, closed_loop, derive,
                       distribution, free, memory_peak_bytes, read_trace,
                       shape)


class ControlDecoder:
    """The reference a step below the configuration's precision (its
    ``control``), with ``run_on_device``'s signature, to stand in the
    program's place."""

    def __init__(self, cell):
        self.channel, self.plan = shape(cell)
        self.control = cell.config["control"]

    def run_on_device(self, words, input_num):
        del input_num
        return reference.control_decode([words], self.channel, self.plan,
                                        self.control)[0], 0.0


def control(cell, device):
    del device
    return ControlDecoder(cell)


def ring(cell, seed: int, device) -> list:
    """The cell's ring of distinct channel streams drawn from ``seed``."""
    config, traffic = cell.config, cell.traffic
    channel = shape(cell)[0]
    return [rs.stream((derive(seed, "rx", i, 0), derive(seed, "rx", i, 1)),
                      traffic["message_bits"], channel, traffic["snr_db"],
                      config["scale"], device)[1]
            for i in range(traffic["ring"])]


def run(cell, ctx) -> Outcome:
    traffic = cell.traffic
    channel, plan = shape(cell)
    input_num = 2 * traffic["message_bits"]
    ctx.mark("imports")
    words = ring(cell, ctx.seed, ctx.device)
    ctx.mark("ring")
    dec = ctx.program(cell, ctx.device) if ctx.program else \
        program.decoder(cell.config, input_num, ctx.device)
    ctx.mark("program")
    for i in range(traffic["warmup_calls"]):
        dec.run_on_device(words[i % len(words)], input_num)
    ctx.mark("warm-up")
    sample = Reservoir(traffic["sample"],
                       random.Random(derive(ctx.seed, "sample")))

    decode_s = []       # the seconds run_on_device returns: a diagnostic

    def call(i):
        slot = i % len(words)
        out, seconds = dec.run_on_device(words[slot], input_num)
        decode_s.append(seconds)
        sample.offer((slot, out))

    window = closed_loop(call, ctx, traffic["trace_calls"],
                         traffic["warmup_calls"])
    peak = memory_peak_bytes(ctx.device)
    window.notes.append(f"the program's event time of its decode launch, "
                        f"ms {distribution(decode_s)}")
    del dec
    free(ctx.device)

    def check():
        slots = sorted({slot for slot, _ in sample.items})
        refs = dict(zip(slots, reference.decode([words[s] for s in slots],
                                                channel, plan)))
        diff = sum(reference.differing_bits(out, refs[slot])
                   for slot, out in sample.items)
        return [Check("decoded_bits_differing", diff, 0)]

    return Outcome(
        attempted=window.calls,
        end_to_end={
            "setup_s": window.start - ctx.start,
            "decode_gbps": window.calls * plan.message_len
            / window.seconds / 1e9,
            "decode_p95_ms": float(np.percentile(window.latencies, 95))
            * 1e3},
        shapes={"channel": channel, "plan": plan,
                "sampled": len(sample.items)},
        memory_peak_bytes=peak, check=check, window=window,
        trace=read_trace(window))

