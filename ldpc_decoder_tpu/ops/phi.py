"""The φ function of sum-product LDPC decoding, in JAX.

φ_abs(x) = -log(tanh(x/2)) on R+, which is self-inverse; φ(x) applies it to
|x| and carries the sign. Matches the reference's fp32 numerics
(flood.cu:31-45): inputs are clamped below at ``pre_threshold = 1e-5``
(bounding the output at ≈ 12.2) and the Taylor tail ``2·e^{-x}`` is used
for x > 5.

The Taylor tail is load-bearing, not just reference parity: a device tanh
that rounds tanh(x/2) to exactly 1.0 for large x (f32 does so from x ≈ 16,
a low-precision hardware tanh much earlier) makes -log(tanh(x/2)) return
-0.0, the message sign is lost and decoding collapses. 2e^{-x} stays
positive down to the high clamp. runtime/smoke.py checks this on the
device, since a CPU test cannot see the device's tanh.

Messages may be *stored* in bf16 (the analog of the reference's fp16 path,
flood.cu:21-29) but φ is always evaluated in fp32 — bf16's 8-bit mantissa
is too coarse for the tanh/log chain.
"""

from __future__ import annotations

import jax.numpy as jnp

PRE_THRESHOLD = 1e-5  # flood.cu:14
TAYLOR_LIMIT = 5.0  # flood.cu:32
# Input high clamp: keeps φ(x) >= 2e^-80 ≈ 3.6e-35 — a *normal* bfloat16 —
# so saturated messages never underflow to ±0 (where the sign, i.e. the
# hard decision, would be lost and near-converged frames explode). The
# reference bounds |LLR| far tighter via its infinity threshold of 10
# (ldpc_decoder_gpu_common.h:27-30); 80 is numerically inert for decoding.
HIGH_THRESHOLD = 80.0


def pre_from_infinity_threshold(t: float | None) -> float:
    """φ-input floor realizing a runtime infinity threshold t.

    The reference's OpenCL backend derives its pre_threshold as
    ``φ(t+1) ≈ 2e^{-(t+1)}`` (flood_vec2.cl:72-74 define
    phi(c_threshold+1) = c_pre_threshold; flood_vec2.cl:187 applies it) —
    flooring φ's input at φ(t+1) caps the output (message magnitude) at
    t + 1, since φ is self-inverse. The CUDA backend ignores the knob and
    hard-codes 1e-5 (≈ cap 12.2, flood.cu:14); ``None`` selects that
    default.
    """
    import math

    if t is None:
        return PRE_THRESHOLD
    return 2.0 * math.exp(-(float(t) + 1.0))


def phi_abs(x: jnp.ndarray, pre: float = PRE_THRESHOLD) -> jnp.ndarray:
    """φ_abs = -log(tanh(x/2)) for x >= 0, fp32, reference-clamped.

    The x > 5 Taylor branch keeps φ positive where tanh(x/2) rounds to 1
    (module docstring). This one formula serves the XLA paths and the
    Pallas kernels alike.
    """
    x32 = x.astype(jnp.float32)
    xm = jnp.clip(x32, jnp.float32(pre), jnp.float32(HIGH_THRESHOLD))
    main = -jnp.log(jnp.tanh(xm * jnp.float32(0.5)))
    return jnp.where(xm > TAYLOR_LIMIT, 2.0 * jnp.exp(-xm), main)


def phi(x: jnp.ndarray, pre: float = PRE_THRESHOLD) -> jnp.ndarray:
    """Signed φ: phi_abs(|x|) with the sign of x (flood.cu:40-45).

    Preserves the sign of ±0 like the reference's bit-twiddled copysign.
    """
    return jnp.copysign(phi_abs(jnp.abs(x), pre), x.astype(jnp.float32))


def phi_abs_np(x, pre: float = PRE_THRESHOLD):
    """Numpy reference implementation (for tests)."""
    import numpy as np

    x = np.asarray(x, dtype=np.float64)
    xm = np.clip(x, pre, HIGH_THRESHOLD)
    main = -np.log(np.tanh(xm * 0.5))
    return np.where(xm > TAYLOR_LIMIT, 2.0 * np.exp(-xm), main)
