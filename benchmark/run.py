"""One run of one cell of the benchmark of ``tpu_viterbi_torch`` on the
card, from the root of a checkout:

    python3 -m benchmark.run --workload soft8-rx32m --seed 7 --seconds 10 \
        --trace 0

It sets the cell up (set-up is counted from the process' start), drives
the program closed loop for ``--seconds``, holds a sample of its answers
to the plain reference, and prints as the last line of its standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of some of the
window's calls), ``device`` and, traced, ``breakdown``; last,
``compared``: each number compared with the reference beside its limit,
which the last lines of standard error repeat.

It exits with another code than 0, and prints no result, where it finds
no card or fewer than the cell asks for (3), where the program is not
beside it (5), and where JAX or the JAX package is loaded when the result
is due, after the window, the comparison and every metric reader (4).
``--control`` puts the reference, a step below the
configuration's precision, in the program's place: its runs must come out
not correct.
"""

import time

START = time.perf_counter()     # set-up is counted from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_viterbi")


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="the reference a step below the configuration's "
                        "precision in the program's place")
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metric_reader(name: str):
    """The module ``metrics/<name>.py`` (a name may hold dots)."""
    from .harness import BENCH_DIR
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card_line() -> str:
    """The card's name, clocks and power limit as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"


def main(argv=None, *, device=None, overrides=None, program=None) -> int:
    """One run; returns the exit code.  ``device``, ``overrides`` (keys of
    the traffic file) and ``program`` (a factory (cell, device) -> the
    object driven in the program's place) are for the CPU tests: with
    ``device`` given, the run does not look for a card."""
    args = parse(argv)
    from . import harness
    try:
        cell = harness.load_cell(args.workload)
    except KeyError as e:
        print(f"benchmark: {e.args[0]}", file=sys.stderr)
        return 2
    cell.traffic.update(overrides or {})
    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA "
                  f"card(s); torch finds "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    marks = [("torch", time.perf_counter())]
    try:
        kind = importlib.import_module(
            f"benchmark.kinds.{cell.traffic['kind']}")
    except ModuleNotFoundError as e:
        if not (e.name or "").startswith("tpu_viterbi_torch"):
            raise
        print(f"benchmark: the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 5
    if args.control:
        program = kind.control
    ctx = harness.Context(args.seed, args.seconds, bool(args.trace), device,
                          START, program, marks)
    outcome = kind.run(cell, ctx)
    on_card = device.type == "cuda"
    if on_card:
        print(f"card: {card_line()}", file=sys.stderr)
    checks = outcome.check()
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(outcome.trace, outcome.shapes)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result = {
        "correct": all(c.ok for c in checks),
        # a call that raises ends the run: every call counted succeeded
        "attempted": outcome.attempted, "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device)
                   if on_card else device.type,
                   "count": cell.chips,
                   "memory_peak_bytes": outcome.memory_peak_bytes}}
    if args.trace:
        result["device"]["busy_s"] = outcome.trace.busy_s
        result["device"]["window_s"] = outcome.trace.window_s
        result["breakdown"] = outcome.trace.breakdown()
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                          for c in checks}
    last, steps = START, []
    for name, t in ctx.marks:
        steps.append(f"{name} {t - last:.3f} s")
        last = t
    print(f"set-up: {', '.join(steps)}", file=sys.stderr)
    print(f"window: {outcome.window.summary()}", file=sys.stderr)
    print(f"sampled answers: {outcome.shapes['sampled']} of "
          f"{outcome.attempted}", file=sys.stderr)
    for c in checks:
        print(f"compared {c.name} {c.value} limit {c.limit}",
              file=sys.stderr)
    # last, once the comparison and every metric reader have run too
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded once the window closed: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
