"""Decoder configuration: option enums, validity table, framing constants, size formulas.

A pure-Python copy of ``tpu_viterbi/config.py`` (the JAX package's
``__init__`` imports jax, so the port cannot import even its config).  The
analog of the reference's compile-time template-options system (reference:
src/viterbi/viterbi.h:7-41 for the bit-packed option word and OptionsValid
gate; :61-87 for the framing constants): a frozen, hashable dataclass whose
derived constants pick the kernel instantiation.

``from_reference`` carries a JAX-side config across through the option
word, so both stacks decode with the same configuration.
"""

from __future__ import annotations

import dataclasses
import enum


class ConfigResolutionError(ValueError):
    """A flag combination that validated syntactically cannot be honored by
    the backend it resolved to at build time (e.g. backend='cuda' with no
    GPU, or a config whose CUDA kernel is not written yet).  The CLI
    converts exactly this class into its reference-style one-line error
    (main.cpp:26-41 analog); any other ValueError is a real bug and keeps
    its traceback.  Subclasses ValueError so library callers catching
    ValueError are unaffected."""


class ChannelIn(enum.IntEnum):
    """Input channel quantization (reference: viterbi.h:17)."""

    HARD = 0x0
    SOFT4 = 0x1
    SOFT8 = 0x2
    SOFT16 = 0x3
    FP32 = 0x4


class Metric(enum.IntEnum):
    """Path-metric dtype (reference: viterbi.h:18).  Values keep the
    reference's bit-packed option encoding (shifted by METRIC_SHIFT)."""

    M_B32 = 0x0 << 4
    M_B16 = 0x1 << 4
    M_FP16 = 0x2 << 4


class DecodeOut(enum.IntEnum):
    """Decoded-output pack width (reference: viterbi.h:19)."""

    O_B32 = 0x0 << 8
    O_B16 = 0x1 << 8


class CompMode(enum.IntEnum):
    """Computation mode (reference: viterbi.h:20): DPX intrinsics vs
    regular ALU ops.  The port's int32 kernel runs both modes on regular
    ALU ops for now; the option is kept for CLI/API parity and config
    round-tripping."""

    REG = 0x0 << 12
    DPX = 0x1 << 12


CHANNEL_SHIFT, METRIC_SHIFT, DECODE_SHIFT, COMP_SHIFT = 0, 4, 8, 12
CHANNEL_MASK = 0xF << CHANNEL_SHIFT
METRIC_MASK = 0xF << METRIC_SHIFT
DECODE_MASK = 0xF << DECODE_SHIFT
COMP_MASK = 0xF << COMP_SHIFT

# --- code constants (reference: viterbi.h:61-63) ---
CONST_LEN = 7                  # constraint length K
POLY1 = 0o171                  # generator polynomial 1 (newest bit = MSB tap)
POLY2 = 0o133                  # generator polynomial 2
NUM_STATES = 1 << (CONST_LEN - 1)  # 64 trellis states

FP_PRECISION = 4               # FP32 inputs clamped to [-8, 7] (viterbi.h:79)


def _roundup(a: int, b: int) -> int:
    if a <= 0:
        return 0
    return (a + b - 1) // b * b


def options_valid(channel_in: ChannelIn, metric: Metric,
                  decode_out: DecodeOut, comp_mode: CompMode) -> bool:
    """Validity table (reference: viterbi.h:22-41 / main.cpp:26-41)."""
    if channel_in == ChannelIn.SOFT8 and metric == Metric.M_FP16:
        return False
    if channel_in == ChannelIn.SOFT16 and metric == Metric.M_FP16:
        return False
    if channel_in == ChannelIn.SOFT16 and metric == Metric.M_B16:
        return False
    if metric == Metric.M_FP16 and comp_mode == CompMode.DPX:
        return False
    return True


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Frozen, hashable decoder configuration.

    Every derived constant is a pure function of the four option fields,
    mirroring the constexpr members of the reference's
    ViterbiCUDA<options> class (viterbi.h:61-87); the CUDA kernel picks
    its template instance from them.
    """

    channel_in: ChannelIn = ChannelIn.HARD
    metric: Metric = Metric.M_B32
    decode_out: DecodeOut = DecodeOut.O_B32
    comp_mode: CompMode = CompMode.REG

    def __post_init__(self):
        if not options_valid(self.channel_in, self.metric,
                             self.decode_out, self.comp_mode):
            raise ValueError(
                f"invalid option combination: {self.channel_in.name} x "
                f"{self.metric.name} x {self.decode_out.name} x "
                f"{self.comp_mode.name}")

    # --- option word (reference bit packing) ---
    @property
    def options(self) -> int:
        return (int(self.channel_in) | int(self.metric)
                | int(self.decode_out) | int(self.comp_mode))

    @classmethod
    def from_options(cls, options: int) -> "DecoderConfig":
        return cls(
            channel_in=ChannelIn(options & CHANNEL_MASK),
            metric=Metric(options & METRIC_MASK),
            decode_out=DecodeOut(options & DECODE_MASK),
            comp_mode=CompMode(options & COMP_MASK),
        )

    # --- framing constants (reference: viterbi.h:67-76) ---
    @property
    def bits_per_metric(self) -> int:
        return {Metric.M_B16: 16, Metric.M_B32: 32, Metric.M_FP16: 11}[self.metric]

    @property
    def bits_per_pack(self) -> int:
        return 16 if self.decode_out == DecodeOut.O_B16 else 32

    @property
    def extra_l(self) -> int:
        # roundup(32, bpp) - (K-1) = 26 for both pack widths
        return _roundup(32, self.bits_per_pack) - (CONST_LEN - 1)

    @property
    def extra_r(self) -> int:
        # roundup(32, bpp) + (K-1) = 38 for both pack widths
        return _roundup(32, self.bits_per_pack) + (CONST_LEN - 1)

    @property
    def slide_size(self) -> int:
        return _roundup(32, self.bits_per_pack)

    @property
    def forward_len(self) -> int:
        return self.extra_l + self.slide_size + self.extra_r

    @property
    def warmup(self) -> int:
        """ACS stages run per block before the first emitted decision
        (= extra_l + extra_r; reference: viterbi.cu:176-183)."""
        return self.extra_l + self.extra_r

    # --- channel packing constants (reference: viterbi.h:80-87) ---
    @property
    def enc_data_per_pack(self) -> int:
        return {ChannelIn.HARD: 32, ChannelIn.SOFT4: 8, ChannelIn.SOFT8: 4,
                ChannelIn.SOFT16: 2, ChannelIn.FP32: 1}[self.channel_in]

    @property
    def enc_data_width(self) -> int:
        return {ChannelIn.HARD: 1, ChannelIn.SOFT4: 4, ChannelIn.SOFT8: 8,
                ChannelIn.SOFT16: 16, ChannelIn.FP32: FP_PRECISION}[self.channel_in]

    @property
    def pm_norm_stride(self) -> int:
        """Periodic renormalization stride (reference: viterbi.cu:173)."""
        return 1 << (self.bits_per_metric - self.enc_data_width - 2)

    # --- size calculators (reference: viterbi.cu:64-100) ---
    def get_input_size(self, input_num: int) -> int:
        """Bytes of packed channel input for `input_num` encoded bits
        (reference: viterbi.cu:64-84)."""
        c = self.channel_in
        if c == ChannelIn.HARD:
            return _roundup(input_num, 8) // 8
        if c == ChannelIn.SOFT4:
            return _roundup(input_num, 2) // 2
        if c == ChannelIn.SOFT8:
            return input_num
        if c == ChannelIn.SOFT16:
            return input_num * 2
        return input_num * 4  # FP32

    def get_input_words(self, input_num: int) -> int:
        """Packed 32-bit words (or float32 values for FP32) of channel input."""
        return -(-input_num // self.enc_data_per_pack)

    def get_message_len(self, input_num: int) -> int:
        """Decoded message bits (reference: viterbi.cu:86-88)."""
        return ((input_num // 2 - (self.extra_l + self.extra_r))
                // self.bits_per_pack * self.bits_per_pack)

    def get_output_size(self, input_num: int) -> int:
        """Bytes of packed decoded output (reference: viterbi.cu:90-92)."""
        return self.get_message_len(input_num) // 8

    def get_output_words(self, input_num: int) -> int:
        return self.get_message_len(input_num) // self.bits_per_pack


ALL_VALID_CONFIGS = tuple(
    DecoderConfig(c, m, o, p)
    for c in ChannelIn for m in Metric for o in DecodeOut for p in CompMode
    if options_valid(c, m, o, p)
)


def from_reference(cfg) -> DecoderConfig:
    """The port's config equal to ``cfg``, any object with the reference's
    integer ``options`` word (e.g. a ``tpu_viterbi.DecoderConfig``) —
    duck-typed so the port never imports the JAX package."""
    return DecoderConfig.from_options(int(cfg.options))
