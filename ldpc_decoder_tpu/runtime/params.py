"""Decoder parameter structs.

Mirror of the reference's static/dynamic parameter split
(h/ldpc_decoder_gpu_common.h:7-54): thread-geometry knobs disappear (XLA
and the kernels' own tiling own scheduling), replaced by dtype/kernel
choices.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class StaticParams:
    """Fixed at decoder construction (h/ldpc_decoder_gpu_common.h:7-22)."""

    # log2 of the max number of frames resident on the device, user cap;
    # the actual value may be lowered by the memory model (default 5,
    # h/ldpc_decoder_gpu_common.h:19)
    max_log_parallel_factor_user: int = 5
    # exact lane-count override (None = memory model chooses a power of
    # two capped by max_log_parallel_factor_user). Any positive count is
    # valid; the Pallas kernels tile lanes by the largest power of two
    # (up to 256) dividing it. Bypasses the memory model — the caller
    # owns the out-of-memory risk.
    parallel_factor_user: int | None = None
    # message storage dtype: "float32", "bfloat16" (the analog of the
    # reference's CUDA fp16 build option, CMakeLists.txt:13-15),
    # "float8_e5m2" (experimental: halves message traffic again; decoded
    # on the XLA path only), or "int8" (fixed-point min-sum, below)
    message_dtype: str = "float32"
    # fraction of device memory kept free (reference reserves 10%,
    # ldpc_decoder_gpu.cu:84-88)
    memory_headroom: float = 0.10
    # override detected per-device HBM bytes (None = autodetect)
    device_memory_bytes: int | None = None
    # node-update implementation (runtime/decoder.choose_kernel): "auto"
    # (the fused Pallas kernels of ops/qc_triton.py for QC codes on a GPU,
    # else XLA), "pallas" (those kernels or an error), or "xla"
    kernel_impl: str = "auto"
    # run the Pallas kernels through the Pallas interpreter (tests only:
    # lets kernel_impl="pallas" run on the CPU)
    pallas_interpret: bool = False
    # recover undeclared circulant structure from plain alist codes
    # (codes/qc.detect_qc_structure): production codes (5G NR, 802.11,
    # DVB-S2, CCSDS) are quasi-cyclic, and detection upgrades them from
    # the generic gather path to the fused rotation kernels with no user
    # action. Costs one O(E·divisors) numpy pass at construction.
    qc_autodetect: bool = True
    # check-node rule: "sum-product" (exact tanh rule in the φ domain,
    # matching the reference, flood.cu:88-114) or "min-sum" (offset/
    # normalized two-minimum approximation; no transcendentals, higher
    # throughput, ~0.05-0.1 dB threshold loss; supported on every
    # kernel path)
    algorithm: str = "sum-product"
    # offset β of offset-min-sum (|out| = max(α·min - β, 0))
    minsum_offset: float = 0.5
    # normalization α of normalized-min-sum: a float (uniform), or a
    # per-check-degree table {degree: α} / ((degree, α), ...) — the
    # degree-matched correction for irregular codes; a 0 key is the
    # fallback for unlisted degrees (ops/qc_decode.resolve_minsum_alpha)
    minsum_alpha: float | tuple = 1.0
    # symmetric LLR clamp applied to min-sum variable messages
    minsum_clamp: float = 64.0
    # int8 fixed-point scale (steps per LLR unit) for message_dtype
    # "int8": messages are stored as round(m * qscale) saturated at ±127,
    # i.e. range ±127/qscale with resolution 1/qscale (the standard
    # hardware min-sum quantization). Must be a power of two so the
    # dequantize multiply is exact in f32.
    minsum_qscale: float = 4.0

    def __post_init__(self):
        # normalize per-degree alpha tables to a hashable tuple of pairs
        # (jit static-arg requirement)
        if isinstance(self.minsum_alpha, dict):
            self.minsum_alpha = tuple(sorted(
                (int(d), float(a)) for d, a in self.minsum_alpha.items()))
        elif isinstance(self.minsum_alpha, (list, tuple)):
            self.minsum_alpha = tuple(
                (int(d), float(a)) for d, a in self.minsum_alpha)
        if (self.parallel_factor_user is not None
                and self.parallel_factor_user <= 0):
            raise ValueError(
                f"parallel_factor_user must be positive, got "
                f"{self.parallel_factor_user}")
        valid = ("float32", "bfloat16", "float8_e5m2", "int8")
        if self.message_dtype not in valid:
            raise ValueError(
                f"message_dtype must be one of {valid}, "
                f"got {self.message_dtype!r}")
        if self.message_dtype == "int8":
            if self.algorithm != "min-sum":
                raise ValueError(
                    "message_dtype='int8' is fixed-point min-sum storage; "
                    "it requires algorithm='min-sum' (the φ-domain "
                    "sum-product messages are not linearly quantizable)")
            import math

            if (self.minsum_qscale <= 0
                    or math.log2(self.minsum_qscale) % 1 != 0):
                raise ValueError(
                    f"minsum_qscale must be a positive power of two for "
                    f"exact dequantization, got {self.minsum_qscale}")


@dataclass
class DynamicParams:
    """Per-decode knobs (h/ldpc_decoder_gpu_common.h:24-54)."""

    # runtime LLR-magnitude cap t: messages are clamped to |m| <= t via a
    # φ-input floor of φ(t) ≈ 2e^{-t}, exactly the reference OpenCL
    # backend's derivation (flood_vec2.cl:187, ldpc_decoder_gpu_common.h:
    # 27-30). None = backend default 1e-5 (cap ≈ 12.2) — the reference
    # CUDA backend's own hard-coded choice (flood.cu:14).
    infinity_threshold: float | None = None
    # NB: lanes refilled by the lane-reset scheme start with one in-kernel
    # reset iteration counted in iters_done, so a REFILLED frame gets at
    # most num_iter_max - 1 real BP iterations (and per-frame iteration
    # stats can overstate by up to num_iter_check_parity); initial-
    # generation frames get the full budget (runtime/decoder.py refill)
    num_iter_max: int = 100
    # iterations between on-device parity checks / refills
    num_iter_check_parity: int = 10
    # iteration of the FIRST parity check (0 = num_iter_check_parity, i.e.
    # the reference's fixed-period behavior). Setting it higher runs the
    # first (first_check - k) iterations as a plain kernel burst with no
    # hard-decision emit, parity kernel, or retire/refill machinery —
    # profitable when no frame can converge that early (e.g. the flagship
    # p41 point at sigma 0.94: true first convergence >= ~60 iterations
    # measured over 2048+ frames, so 56 skips three provably-futile
    # checks). Applies to the initial generation only; refilled lanes are
    # checked every k as usual. A frame that would converge during the
    # burst is still decoded correctly — it just retires at the first
    # post-burst check, so a too-large value costs throughput, never
    # correctness.
    num_iter_first_check: int = 0
    # frames per run = parallel_factor * loading_factor (main.cpp:320)
    loading_factor: int = 4
    target_errors: int = 0
    num_vectors_per_run: int = 0  # filled by the harness
