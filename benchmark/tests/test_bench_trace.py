"""The reading of a trace, on a trace written by hand, and the per-layer
metrics on it; then a traced run on the CPU end to end."""

import json

import pytest

from benchmark import framing, rooflines, run, trace
from benchmark.reference_stream import CHANNELS

K1 = ("void viterbi_kernel<WordReader<8>, 32, false, true>(Source, "
      "unsigned int*, int*, int, int, int, int, int, int)")
K7 = "void viterbi_gen::gen_words_kernel<8, true>(int*, int*, int)"
CAT = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int, "
       "unsigned int, 1, 128, 1>(int*, int)")


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


EVENTS = [
    _ev(trace.CALL_SPAN, "user_annotation", 0, 100),
    _ev(trace.CALL_SPAN, "user_annotation", 120, 100),
    _ev("cudaLaunchKernel", "cuda_runtime", 2, 6),
    _ev("cudaEventSynchronize", "cuda_runtime", 20, 55),
    _ev("cudaStreamSynchronize", "cuda_runtime", 200, 30),   # past the end
    _ev("aten::cat", "cpu_op", 80, 15),
    _ev("cudaLaunchKernel", "cuda_runtime", 85, 4),
    _ev("cudaEventSynchronize", "cuda_runtime", 140, 55),
    _ev(K1, "kernel", 10, 60, tid=7),
    _ev(K7, "kernel", 65, 10, tid=7),        # overlaps K1's end
    _ev(CAT, "kernel", 90, 5, tid=7),
    _ev(K1, "kernel", 130, 60, tid=7),
    _ev("Memcpy DtoH", "gpu_memcpy", 215, 10, tid=7),         # clipped
    _ev("cudaEventRecord", "cuda_runtime", 100, 5, tid=2),   # other thread
]


def test_window_busy_and_kernels():
    t = trace.Trace(EVENTS)
    assert t.calls == 2 and t.window_s == pytest.approx(220e-6)
    # busy: [10, 75) + [90, 95) + [130, 190) + [215, 220)
    assert t.busy_s == pytest.approx(135e-6)
    assert t.kernel_s(("viterbi_kernel",)) == pytest.approx(120e-6)
    assert t.kernel_s(("gen_words_kernel",)) == pytest.approx(10e-6)
    assert t.sync_s() == pytest.approx((55 + 55 + 20) * 1e-6)
    assert t.call_host_s == pytest.approx(200e-6)


def test_breakdown():
    b = trace.Trace(EVENTS).breakdown()
    ops = dict(b["device_ops"])
    assert ops["viterbi_kernel<WordReader<8>, 32, false, true>"] \
        == pytest.approx(120e-6)
    assert ops["at::native::{anon}::CatArrayBatchedCopy<int, unsigned int, "
               "1, 128, 1>"] == pytest.approx(5e-6)
    idle = dict(b["idle_gaps"])
    # gaps [0, 10): launch 2-8, rest 8 of nothing; [75, 90): cat 80-85,
    # launch 85-89, cat 89-90; [95, 130); [190, 215): sync 200-215
    assert idle["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert idle["aten::cat"] == pytest.approx(6e-6)
    assert idle["cudaStreamSynchronize"] == pytest.approx(15e-6)
    assert sum(idle.values()) == pytest.approx(220e-6 - 135e-6)
    assert len(b["device_ops"]) <= trace.TOP


def test_per_layer_readers():
    t = trace.Trace(EVENTS)
    plan = framing.plan(32_000_000, 2048, 32)
    shapes = {"channel": CHANNELS["SOFT8"], "plan": plan, "noisy": True}
    bound = rooflines.bound_s(rooflines.decode_terms(CHANNELS["SOFT8"],
                                                     plan))
    read = run.metric_reader
    assert read("decode_roofline_pct.rx")(t, shapes) == pytest.approx(
        100 * bound / 60e-6)
    gen = rooflines.bound_s(rooflines.generate_terms(CHANNELS["SOFT8"],
                                                     32_000_000))
    assert read("gen_roofline_pct.sim")(t, shapes) == pytest.approx(
        100 * gen / 5e-6)
    assert read("device_idle_pct.sim")(t, shapes) == pytest.approx(
        100 * 85 / 220)
    assert read("api_host_ms.rx")(t, shapes) == pytest.approx(0.1 - 0.06)
    assert read("sim_sync_ms.sim")(t, shapes) == pytest.approx(0.065)


def test_readers_find_nothing_without_their_kernels():
    t = trace.Trace([e for e in EVENTS if e.get("cat") != "kernel"])
    shapes = {"channel": CHANNELS["FP32"],
              "plan": framing.plan(1_000_000, 2048, 32), "noisy": True}
    for name in ("decode_roofline_pct.rx", "decode_roofline_pct.sim",
                 "gen_roofline_pct.sim", "api_host_ms.rx"):
        assert run.metric_reader(name)(t, shapes) is None


def test_traced_run_on_the_cpu(capsys):
    """--trace 1 end to end on the CPU: the per-layer metrics that find
    something to read, the traced window, the breakdown."""
    rc = run.main(["--workload", "soft8-rx1m", "--seed", "5", "--seconds",
                   "0.2", "--trace", "1"], device="cpu",
                  overrides={"message_bits": 4000, "ring": 2,
                             "warmup_calls": 1, "sample": 2,
                             "trace_calls": 2})
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    # no device kernels on the CPU: the rooflines and the host share
    # read nothing, the idle share reads the whole window
    assert set(result["metrics"]) == {"device_idle_pct.rx"}
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
