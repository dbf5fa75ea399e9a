from .api import ViterbiGPU
from .core_cuda import K1, K2, K3, decode_packed_cuda
from .core_torch import (BlockPlan, decode_packed_torch, plan_blocks,
                         plan_from_reference)
from .streaming import StreamingViterbi

__all__ = [
    "ViterbiGPU", "K1", "K2", "K3", "decode_packed_cuda", "BlockPlan",
    "decode_packed_torch", "plan_blocks", "plan_from_reference",
    "StreamingViterbi",
]
