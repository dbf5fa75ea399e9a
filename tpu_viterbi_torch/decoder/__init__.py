from .api import ViterbiGPU
from .core_cuda import (K1, K2, K3, K4, K5, K6, decode_blocks_cuda,
                        decode_packed_cuda)
from .core_torch import (BlockPlan, decode_blocks, decode_packed_torch,
                         forward_scan, gather_blocks, plan_blocks,
                         plan_from_reference, traceback_scan)
from .golden import golden_decode_block, golden_decode_full
from .streaming import StreamingViterbi

__all__ = [
    "ViterbiGPU", "K1", "K2", "K3", "K4", "K5", "K6", "decode_blocks_cuda",
    "decode_packed_cuda", "BlockPlan", "decode_blocks", "decode_packed_torch",
    "forward_scan", "gather_blocks", "plan_blocks", "plan_from_reference",
    "traceback_scan", "golden_decode_block", "golden_decode_full",
    "StreamingViterbi",
]
