"""Dataflow micro-framework: elements chained with ``|``, per-element timing,
probing of intermediate outputs, and a printable status map.

Port of ``tpu_viterbi/chain/pipeline.py``, the rebuild of the reference's
C++ dataflow layer (reference: src/dataflow/dataflow.h:16-133).  Semantics
kept:
  - an element's ``process(data)`` receives the previous element's output
    (None for the first element, which generates its own data);
  - ``probe()`` marks an element so its output is captured in the result;
  - ``Pipeline.run`` wall-clocks every element into an "Elapsed run time"
    status entry and returns (final_output, probed_outputs).
CUDA work is launched asynchronously, so each element's output is awaited
with ``torch.cuda.synchronize`` before its clock stops: its time is billed
to it, not to its successor.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch


def _block(x):
    """Await the device work behind a CUDA tensor so per-element timing
    bills the right stage, and device-side faults surface on the element
    that caused them.  Anything else passes through."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


class ComputeElement:
    """Base pipeline element (reference: dataflow.h:16-71)."""

    def __init__(self):
        self._probed = False
        self.status: Dict[str, Any] = {}

    def process(self, data: Optional[Any]) -> Any:
        raise NotImplementedError

    def probe(self) -> "ComputeElement":
        self._probed = True
        return self

    @property
    def is_probed(self) -> bool:
        return self._probed

    def set_status(self, key: str, value: Any) -> None:
        self.status[key] = value

    def get_status(self, key: str) -> Any:
        return self.status[key]

    def get_status_string(self, key: str) -> str:
        value = self.status[key]
        if key in ("Elapsed run time", "kernel time"):
            return _format_seconds(value)
        return str(value)

    def __or__(self, other: "ComputeElement") -> "Pipeline":
        return Pipeline([self, other])


def _format_seconds(seconds: float) -> str:
    """Pretty-print matching the reference's unit scaling
    (dataflow.h:49-70, viterbiDF.h:197-208)."""
    if seconds >= 1.0:
        return f"{seconds:.2f} s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.2f} ms"
    return f"{seconds * 1e6:.0f} us"


@dataclass
class PipelineResult:
    """(reference: dataflow.h:74-77)"""

    final_output: Any
    probed_outputs: List[Any] = field(default_factory=list)


class Pipeline:
    """Ordered element list with timed execution (reference: dataflow.h:80-133)."""

    def __init__(self, elements: Optional[List[ComputeElement]] = None):
        self.elements: List[ComputeElement] = list(elements or [])

    def add(self, e: ComputeElement) -> "Pipeline":
        self.elements.append(e)
        return self

    def __or__(self, other: ComputeElement) -> "Pipeline":
        return self.add(other)

    def run(self) -> PipelineResult:
        cur: Optional[Any] = None
        probes: List[Any] = []
        for e in self.elements:
            start = time.perf_counter()
            cur = _block(e.process(cur))
            e.set_status("Elapsed run time", time.perf_counter() - start)
            if e.is_probed:
                probes.append(cur)
        if cur is None:
            raise RuntimeError("Pipeline produced no output")
        return PipelineResult(cur, probes)

    def status_lines(self) -> List[str]:
        lines = ["--- Pipeline Status ---"]
        for i, e in enumerate(self.elements):
            lines.append(f"Element {i} (type: {type(e).__name__}):")
            if not e.status:
                lines.append("  - No status information.")
            for key in e.status:
                lines.append(f"  - {key}: {e.get_status_string(key)}")
        lines.append("--- End of Status ---")
        return lines

    def print_status(self) -> None:
        print("\n".join(self.status_lines()))
