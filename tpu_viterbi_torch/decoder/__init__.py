from .api import ViterbiGPU
from .core_cuda import K1, decode_packed_cuda
from .core_torch import (BlockPlan, decode_packed_torch, plan_blocks,
                         plan_from_reference)

__all__ = [
    "ViterbiGPU", "K1", "decode_packed_cuda", "BlockPlan",
    "decode_packed_torch", "plan_blocks", "plan_from_reference",
]
