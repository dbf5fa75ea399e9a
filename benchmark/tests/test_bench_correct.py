"""``correct`` on the CPU at a test size: a sound run of each kind comes out
correct; the control (the reference a step below the configuration's
precision in the program's place) and a run whose timed path is broken
underneath come out not correct.  Each drives the whole run but the look
for a card (``run.main(device="cpu")``), the program on its plain
versions."""

import json

import pytest
import torch

from benchmark import program, run

SMALL = {"message_bits": 6000, "ring": 2, "warmup_calls": 1, "sample": 3,
         "trace_calls": 2}
SIM_SMALL = dict(SMALL, sample=2)


def _run(capsys, workload, extra=(), prog=None, seed=20261018,
         overrides=None):
    small = SIM_SMALL if "sim" in workload else SMALL
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0.3", "--trace", "0", *extra],
                  device="cpu", overrides=dict(small, **(overrides or {})),
                  program=prog)
    assert rc == 0
    out = capsys.readouterr()
    result = json.loads(out.out.strip().splitlines()[-1])
    assert out.err.strip().splitlines()[-1].startswith("compared ")
    return result


@pytest.mark.parametrize("workload", ["soft8-rx32m", "fp32-rx32m",
                                      "soft8-sim32m"])
def test_sound_run_is_correct(capsys, workload):
    result = _run(capsys, workload)
    assert result["correct"] is True
    assert list(result)[-1] == "compared"
    assert all(c["value"] == 0 for c in result["compared"].values())


@pytest.mark.parametrize("workload,seed", [
    ("soft8-rx32m", 1), ("soft8-rx32m", 2), ("soft8-rx32m", 3),
    ("soft8-sim32m", 4)])
def test_int8_metrics_control_is_not_correct(capsys, workload, seed):
    result = _run(capsys, workload, ["--control"], seed=seed)
    assert result["correct"] is False
    assert result["compared"]["decoded_bits_differing"]["value"] > 1000


def test_bf16_wire_control_is_not_correct(capsys):
    """The f32 wire rounded to bfloat16 moves a decision only where two
    paths nearly tie, so it needs a longer message than the other tests
    (two of 2M bits on the CPU read 2 to 15 bits apart)."""
    result = _run(capsys, "fp32-rx32m", ["--control"], seed=12,
                  overrides={"message_bits": 2_000_000, "ring": 1,
                             "sample": 1, "warmup_calls": 0})
    assert result["correct"] is False
    assert result["compared"]["decoded_bits_differing"]["value"] > 0


class _Broken:
    """The program's decoder with a fault planted where it answers."""

    def __init__(self, inner, fault):
        self.inner, self.fault, self.last = inner, fault, None

    def run_on_device(self, words, input_num):
        out, seconds = self.inner.run_on_device(words, input_num)
        out = out.clone()
        if self.fault == "flip":            # an answer altered
            out[out.shape[0] // 2] ^= 1 << 9
        elif self.fault == "half":          # half the blocks left out
            out[out.shape[0] // 2:] = 0
        elif self.fault == "stale":         # the state handed back as it was
            out, self.last = (out if self.last is None else self.last), out
        return out, seconds


@pytest.mark.parametrize("fault", ["flip", "half", "stale"])
def test_broken_decoder_is_not_correct(capsys, fault):
    def factory(cell, device):
        inner = program.decoder(cell.config,
                                2 * cell.traffic["message_bits"], device)
        return _Broken(inner, fault)
    result = _run(capsys, "soft8-rx32m", prog=factory,
                  overrides={"sample": 4, "warmup_calls": 2})
    assert result["correct"] is False


@pytest.mark.parametrize("fault", ["count", "flip", "half"])
def test_broken_simulation_is_not_correct(capsys, fault):
    def factory(cell, device):
        simulate, _ = program.simulation(cell.config, cell.traffic, device)

        def broken(seed):
            ben, out = simulate(seed)
            out = out.clone()
            if fault == "count":
                return ben + 1, out
            if fault == "flip":
                out[3] ^= 1
            else:
                out[out.shape[0] // 2:] = 0
            return ben, out
        return broken
    result = _run(capsys, "soft8-sim32m", prog=factory)
    assert result["correct"] is False


def test_reservoir_keeps_a_uniform_sample():
    import random

    from benchmark.harness import Reservoir
    counts = torch.zeros(20)
    for s in range(400):
        r = Reservoir(5, random.Random(s))
        for i in range(20):
            r.offer(i)
        assert len(r.items) == 5 and len(set(r.items)) == 5
        counts[list(r.items)] += 1
    assert counts.min() > 60 and counts.max() < 140     # 100 expected
