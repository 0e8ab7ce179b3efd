"""On-device numerics check of φ (ops/phi.py).

The φ chain -log(tanh(x/2)) is evaluated with the device's own tanh and
log, which differ from the CPU's. Two failure modes matter for decoding:
a tanh that rounds to exactly 1.0 makes φ return -0.0 and loses the
message sign (the x > 5 Taylor branch 2e^{-x}, also the reference's
numerics, keeps φ positive there), and an inaccurate tanh near 1 puts an
absolute error of the same size on φ. CPU tests cannot see either, so
chip_smoke.py and bench.py run this check on the device first.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# error model of φ against float64: a relative bound plus an absolute
# floor for φ near 0. Measured on an NVIDIA H100 (XLA's GPU tanh, log and
# exp): worst relative error 4.2e-6, worst absolute 5.0e-7; the bounds
# leave about 5x headroom
PHI_REL_TOL = 2e-5
PHI_ABS_TOL = 2e-6


def phi_numerics_smoke(verbose=print, rel_tol: float = PHI_REL_TOL,
                       abs_tol: float = PHI_ABS_TOL) -> dict:
    """Assert the φ invariants hold on the default device.

    Returns the measured worst relative and absolute errors. Raises
    AssertionError on a regression. Pure elementwise checks.
    """
    from ldpc_decoder_tpu.ops.phi import HIGH_THRESHOLD, phi_abs, phi_abs_np

    dev = jax.devices()[0]
    # 1. where the device's tanh saturates (diagnostic)
    args = jnp.arange(4.0, 16.0, 0.5, dtype=jnp.float32)
    t = np.asarray(jax.jit(jnp.tanh)(args))
    sat = np.flatnonzero(t >= 1.0)
    sat_at = float(args[sat[0]]) if sat.size else None
    verbose(f"smoke[{dev.platform}]: tanh saturates to 1.0 at arg "
            f"{'>= %.1f' % sat_at if sat_at is not None else 'never'}")

    # 2. φ stays strictly positive up to the high clamp (the sign of a
    #    saturated message survives)
    xs = jnp.array([6.0, 12.0, 25.0, 50.0, HIGH_THRESHOLD], jnp.float32)
    vals = np.asarray(jax.jit(phi_abs)(xs))
    assert (vals > 0.0).all(), (
        f"phi_abs returned non-positive values {vals} at {np.asarray(xs)} "
        f"on {dev}: the x>5 Taylor branch (ops/phi.py) has regressed")

    # 3. φ matches the float64 reference across the operating range,
    #    including the tanh/Taylor crossover at 5.0
    grid = np.concatenate([
        np.geomspace(1e-5, 4.9, 64), np.linspace(5.1, 79.0, 32)])
    got = np.asarray(jax.jit(phi_abs)(jnp.asarray(grid, jnp.float32)))
    want = phi_abs_np(grid)
    err = np.abs(got - want)
    rel = err / want
    bad = err > want * rel_tol + abs_tol
    assert not bad.any(), (
        f"phi_abs deviates from the f64 reference by abs {err[bad].max():.2e}"
        f" (worst at x={grid[bad][np.argmax(err[bad])]:.4g}, beyond rel "
        f"{rel_tol:g} + abs {abs_tol:g}) on {dev}")

    # 4. the self-inverse roundtrip keeps the operating range stable
    mid = jnp.asarray(np.geomspace(1e-4, 11.0, 32), jnp.float32)
    rt = np.asarray(jax.jit(lambda v: phi_abs(phi_abs(v)))(mid))
    rt_rel = np.abs(rt - np.asarray(mid)) / np.asarray(mid)
    assert rt_rel.max() < 2e-2, (
        f"phi roundtrip error {rt_rel.max():.2e} on {dev}")
    out = {"phi_max_rel_err": float(rel.max()),
           "phi_max_abs_err": float(err.max()),
           "roundtrip_max_rel_err": float(rt_rel.max())}
    verbose(f"smoke[{dev.platform}]: phi invariants OK (phi(12)="
            f"{vals[1]:.3e}, max rel err {out['phi_max_rel_err']:.2e}, "
            f"max abs err {out['phi_max_abs_err']:.2e})")
    return out
