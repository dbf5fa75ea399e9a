"""The program's ranges and the device operations they launched, on a
trace written by hand with ``correlation`` args, and the five per-layer
metrics that read them."""

import pytest

from benchmark import framing, run, spans, trace
from benchmark.reference_stream import CHANNELS

K1 = ("void viterbi_kernel<IntReader<8, false, false, false>, 32, false, "
      "true>(Source, unsigned int*, int*, int, int, int, int, int, int)")
K7 = "void viterbi_gen::gen_words_kernel<8, true>(int*, int*, int)"
XOR = "void at::native::vectorized_elementwise_kernel<4, BitwiseXor>(int)"
POP = "void at::native::reduce_kernel<512, 1, Popcount>(int)"
CAT = "void at::native::CatArrayBatchedCopy<int, 128>(int*, int)"
STRAY = "void at::native::elementwise_kernel<128, 4, Stray>(int)"


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _range(name, ts, dur):
    return _ev(name, "user_annotation", ts, dur)


def _launch(ts, corr, name="cudaLaunchKernel"):
    return _ev(name, "cuda_runtime", ts, 3, corr=corr)


def _op(name, ts, dur, corr, cat="kernel"):
    return _ev(name, cat, ts, dur, tid=7, corr=corr)


def call(t0, c0):
    """One traced simulate call at t0, correlations from c0: K7 launched
    in generate, an elementwise kernel in ref, K1 in api.launch, the
    output's cat in api.assemble, a reduction and a set in count, and a
    kernel whose launch is missing."""
    t = t0
    return [
        _range(trace.CALL_SPAN, t, 200),
        _range("simulate", t + 2, 188),
        _range("generate", t + 4, 26),
        _range("K7", t + 8, 6),
        _launch(t + 10, c0 + 1),
        _op(K7, t + 15, 25, c0 + 1),
        _range("ref", t + 32, 18),
        _launch(t + 35, c0 + 2),
        _op(XOR, t + 42, 5, c0 + 2),
        _range("api.call", t + 52, 118),
        _range("api.stage", t + 54, 16),
        _range("decode", t + 72, 78),
        _range("api.launch", t + 74, 26),
        _range("K1", t + 80, 15),
        _launch(t + 85, c0 + 3),
        _op(K1, t + 90, 50, c0 + 3),
        _range("api.wait", t + 102, 46),
        _ev("cudaEventSynchronize", "cuda_runtime", t + 103, 43),
        _range("api.assemble", t + 152, 13),
        _launch(t + 155, c0 + 4),
        _op(CAT, t + 158, 2, c0 + 4),
        _range("count", t + 172, 13),
        _launch(t + 174, c0 + 5),
        _op(POP, t + 176, 4, c0 + 5),
        _launch(t + 178, c0 + 6, "cudaMemsetAsync"),
        _op("Memset (Device)", t + 181, 1, c0 + 6, "gpu_memset"),
        _op(STRAY, t + 186, 2, c0 + 99),        # its launch is missing
    ]


EVENTS = call(0, 0) + call(200, 100)
SHAPES = {"channel": CHANNELS["SOFT8"],
          "plan": framing.plan(32_000_000, 2048, 32), "noisy": True}
READERS = ("api_own_ms.rx", "launch_host_ms.rx", "sim_own_ms.sim",
           "count_device_ms.sim", "count_launches.sim")


def test_ranges_of_a_name():
    t = trace.Trace(EVENTS)
    assert spans.ranges(t, "api.launch") == [(74, 100), (274, 300)]
    assert spans.total_ms(spans.ranges(t, "api.wait")) == \
        pytest.approx(0.092)


def test_each_operation_links_to_its_launch():
    t = trace.Trace(EVENTS)
    starts = dict((op["args"]["correlation"], ts)
                  for op, ts in spans.linked(t) if ts is not None)
    assert starts == {1: 10, 2: 35, 3: 85, 4: 155, 5: 174, 6: 178,
                      101: 210, 102: 235, 103: 285, 104: 355, 105: 374,
                      106: 378}
    unlinked = [op["name"] for op, ts in spans.linked(t) if ts is None]
    assert unlinked == [STRAY, STRAY]


def test_operations_by_the_range_that_launched_them():
    t = trace.Trace(EVENTS)

    def names(ranges, cats=trace.DEVICE_CATEGORIES):
        return [op["name"] for op in spans.launched_in(t, ranges, cats)]

    assert names(("count",)) == [POP, "Memset (Device)"] * 2
    assert names(("ref", "count"), ("kernel",)) == [XOR, POP] * 2
    assert names(("api.launch",)) == [K1, K1]
    assert names(("decode",)) == names(("K1",)) == [K1, K1]
    assert names(("api.call",)) == [K1, CAT] * 2
    assert names(("generate",)) == [K7, K7]
    # the stray kernel's launch is missing: it belongs to no range, not
    # even the call's
    assert STRAY not in names((trace.CALL_SPAN, "simulate"))
    assert spans.launched_in(t, ("no such range",)) is None


def test_own_time_less_the_wait_inside():
    t = trace.Trace(EVENTS)
    assert spans.own_ms(t, "api.call") == pytest.approx(0.118 - 0.046)
    assert spans.own_ms(t, "simulate") == pytest.approx(0.188 - 0.046)
    # a wait outside the range is not taken off
    assert spans.own_ms(t, "api.stage") == pytest.approx(0.016)
    assert spans.own_ms(t, "no such range") is None


def test_the_five_readers_by_hand():
    t = trace.Trace(EVENTS)
    got = {name: run.metric_reader(name)(t, SHAPES) for name in READERS}
    assert got == pytest.approx({
        "api_own_ms.rx": 0.072,             # api.call 118 - api.wait 46 us
        "launch_host_ms.rx": 0.026,         # api.launch 26 us
        "sim_own_ms.sim": 0.142,            # simulate 188 - api.wait 46
        "count_device_ms.sim": 0.010,       # XOR 5 + POP 4 + memset 1
        "count_launches.sim": 2.0})         # XOR, POP


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_a_decode_kernel(name):
    t = trace.Trace([e for e in EVENTS if e["name"] != K1])
    assert run.metric_reader(name)(t, SHAPES) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_the_programs_ranges(name):
    """A program without the ranges (an older tree) reads as nothing, and
    no reader raises."""
    kept = {trace.CALL_SPAN, "K1", "K7", "generate"}
    t = trace.Trace([e for e in EVENTS if e["cat"] != "user_annotation"
                     or e["name"] in kept])
    assert run.metric_reader(name)(t, SHAPES) is None
