"""Flood (sum-product) belief-propagation decode kernels, jnp/XLA path.

A re-design of the reference's device kernels (flood.cu:77-223,
flood_vec2.cl:174-448). Algorithmic identity is preserved — messages live in
the self-inverse φ-domain after the variable-node pass, check nodes use the
abs-sum/sign-parity split against the syndrome, hard decisions are
``total >= +0`` — but the mapping is XLA-native:

- All arrays put frames on the trailing (lane) axis: ``[rows, B]``.
- The persistent state is the message array in *check-major sorted edge
  order* ``msgs_c [E, B]``; check/variable nodes are degree-sorted so both
  passes are static reshape+reduce over degree buckets (no CSR walking).
- One BP iteration costs exactly two row gathers: ``r_c[perm_c2v]`` (to sum
  check messages per variable) and ``totals[cn_edge_vnrow]`` (to broadcast
  variable totals back to check-major edges). The leave-one-out subtraction
  then happens in place in check order, fusing the reference's
  flood_forward into the same edge order as flood_backward.

Every function here is shape-static and jittable; the batch axis can be
sharded (each frame's Tanner graph lives whole on one device, so no
cross-device traffic occurs inside an iteration).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_decoder_tpu.codes.compiled import CompiledCode, DegreeBucket
from ldpc_decoder_tpu.ops.phi import PRE_THRESHOLD, phi_abs
from ldpc_decoder_tpu.ops.qc_decode import (
    dequantize_msgs,
    quantize_msgs,
    resolve_minsum_alpha,
)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "perm_c2v",
        "perm_v2c",
        "cn_edge_vnrow",
        "vn_pos",
        "vn_order",
        "cn_order",
        "erased_mask_sorted",
    ],
    meta_fields=["n_vars", "n_checks", "n_edges", "vn_buckets", "cn_buckets"],
)
@dataclasses.dataclass(frozen=True)
class DecodeTables:
    """Device-resident constants of one compiled code.

    A pytree whose leaves are the jnp index arrays (replicated per device)
    and whose static metadata (sizes, degree buckets) is baked into the
    jitted program.
    """

    n_vars: int
    n_checks: int
    n_edges: int
    perm_c2v: jnp.ndarray  # [E] int32: vn-edge s -> cn-edge of same edge
    perm_v2c: jnp.ndarray  # [E] int32: cn-edge t -> vn-edge of same edge
    cn_edge_vnrow: jnp.ndarray  # [E] int32: cn-edge t -> sorted vn row
    vn_pos: jnp.ndarray  # [n_vars] natural var id -> sorted row
    vn_order: jnp.ndarray  # [n_vars] sorted row -> natural var id
    cn_order: jnp.ndarray  # [n_checks]
    erased_mask_sorted: jnp.ndarray  # [n_vars, 1] bool: erased variables
    vn_buckets: tuple[DegreeBucket, ...]
    cn_buckets: tuple[DegreeBucket, ...]

    @staticmethod
    def from_compiled(cc: CompiledCode) -> "DecodeTables":
        code = cc.code
        # erased variables are the trailing natural indices (main.cpp:529-530)
        erased_nat = np.zeros(code.n_vars, dtype=bool)
        if code.n_erased_vars:
            erased_nat[code.n_vars - code.n_erased_vars :] = True
        return DecodeTables(
            n_vars=code.n_vars,
            n_checks=code.n_checks,
            n_edges=code.n_edges,
            perm_c2v=jnp.asarray(cc.perm_c2v),
            perm_v2c=jnp.asarray(cc.perm_v2c),
            cn_edge_vnrow=jnp.asarray(cc.cn_edge_vnrow),
            vn_pos=jnp.asarray(cc.vn_pos),
            vn_order=jnp.asarray(cc.vn_order),
            cn_order=jnp.asarray(cc.cn_order),
            erased_mask_sorted=jnp.asarray(erased_nat[cc.vn_order])[:, None],
            vn_buckets=cc.vn_buckets,
            cn_buckets=cc.cn_buckets,
        )


def _bucket_view(x: jnp.ndarray, b: DegreeBucket) -> jnp.ndarray:
    """Edge rows of one degree bucket as [count, degree, B]."""
    n = b.count * b.degree
    return x[b.edge_start : b.edge_start + n].reshape(
        b.count, b.degree, x.shape[-1]
    )


def cn_update(
    msgs_c: jnp.ndarray,  # [E, B] φ-domain VN→CN messages, cn-edge order
    syn: jnp.ndarray,  # [n_checks, B] int8/bool syndrome bits, sorted order
    tables: DecodeTables,
    phi_pre: float = PRE_THRESHOLD,
) -> jnp.ndarray:
    """Check-node (flood_backward) pass: returns CN→VN messages r_c [E, B].

    Per check c with syndrome bit s: ext = Σ|m_e|; parity = s ⊕ ⊕(sign(m_e)
    is non-negative); r_e = ±phi_abs(ext − |m_e|), negative iff
    signbit(m_e) ⊕ parity (flood.cu:88-114).
    """
    out = []
    syn_i = syn.astype(jnp.int32)
    for b in tables.cn_buckets:
        m = _bucket_view(msgs_c, b).astype(jnp.float32)
        neg = jnp.signbit(m)
        a = jnp.abs(m)
        ext = jnp.sum(a, axis=1, keepdims=True)  # [count, 1, B]
        # parity of "bit = 1" votes: positive LLR ⇔ bit 1 (common.h:51-54)
        pos_votes = jnp.sum(1 - neg.astype(jnp.int32), axis=1, keepdims=True)
        s = syn_i[b.row_start : b.row_start + b.count][:, None, :]
        parity = (s + pos_votes) & 1  # [count, 1, B]
        res = phi_abs(ext - a, phi_pre)
        is_neg = (neg.astype(jnp.int32) ^ parity) == 1
        r = jnp.where(is_neg, -res, res)
        # keep the big intermediate in the message dtype: halves the
        # device-memory bytes of the materialized array and of the edge-permutation gather
        out.append(r.reshape(b.count * b.degree, -1).astype(msgs_c.dtype))
    return jnp.concatenate(out, axis=0)


def vn_totals(
    r_v: jnp.ndarray,  # [E, B] CN→VN messages in vn-edge order
    llr: jnp.ndarray,  # [n_vars, B] channel LLRs, sorted order
    tables: DecodeTables,
) -> jnp.ndarray:
    """Variable totals: llr + Σ incoming (flood.cu:132-139). [n_vars, B]."""
    sums = []
    for b in tables.vn_buckets:
        sums.append(jnp.sum(_bucket_view(r_v, b).astype(jnp.float32), axis=1))
    return llr + jnp.concatenate(sums, axis=0)


def parity_violations(
    bits: jnp.ndarray,  # [n_vars, B] int8 hard decisions, sorted order
    syn: jnp.ndarray,  # [n_checks, B]
    tables: DecodeTables,
) -> jnp.ndarray:
    """Per-frame "any check violated" flags [B] (check_parity,
    flood.cu:191-223)."""
    bits_c = jnp.take(bits, tables.cn_edge_vnrow, axis=0)  # [E, B]
    viol = []
    for b in tables.cn_buckets:
        # int8 accumulator (values <= degree <= 126): an int32 one
        # materializes a full edge-sized s32 temp before the reduce
        acc = jnp.int8 if b.degree <= 126 else jnp.int32
        x = jnp.sum(_bucket_view(bits_c, b), axis=1, dtype=acc)
        s = syn[b.row_start : b.row_start + b.count].astype(acc)
        viol.append(((x + s) & 1) > 0)
    return jnp.any(jnp.concatenate(viol, axis=0), axis=0)  # [B]


def syndrome_from_bits(
    bits: jnp.ndarray,  # [n_vars, B] int8 bits, sorted vn order
    tables: DecodeTables,
) -> jnp.ndarray:
    """Syndrome in sorted cn order: XOR of bits over each check's edges
    (device twin of ldpc_code.cpp:256-286). [n_checks, B] int8."""
    bits_c = jnp.take(bits, tables.cn_edge_vnrow, axis=0)
    out = []
    for b in tables.cn_buckets:
        acc = jnp.int8 if b.degree <= 126 else jnp.int32
        x = jnp.sum(_bucket_view(bits_c, b), axis=1, dtype=acc)
        out.append((x & 1).astype(jnp.int8))
    return jnp.concatenate(out, axis=0)


def bp_iteration(
    msgs_c: jnp.ndarray,  # [E, B] state (possibly bf16)
    llr: jnp.ndarray,
    syn: jnp.ndarray,
    tables: DecodeTables,
    phi_pre: float = PRE_THRESHOLD,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One full flood iteration. Returns (new msgs_c, totals)."""
    r_c = cn_update(msgs_c, syn, tables, phi_pre)
    r_v = jnp.take(r_c, tables.perm_c2v, axis=0)
    totals = vn_totals(r_v, llr, tables)
    # gather totals in the message dtype (halves gather bytes); the
    # subtraction below upcasts back to f32 for phi
    t_edge = jnp.take(
        totals.astype(msgs_c.dtype), tables.cn_edge_vnrow, axis=0
    )  # [E, B]
    pre = t_edge.astype(jnp.float32) - r_c.astype(jnp.float32)
    new = jnp.copysign(phi_abs(jnp.abs(pre), phi_pre), pre)
    return new.astype(msgs_c.dtype), totals


def cn_update_minsum(
    msgs_c: jnp.ndarray,  # [E, B] LLR-domain messages, cn-edge order
    syn: jnp.ndarray,  # [n_checks, B]
    tables: DecodeTables,
    beta: float,
    alpha=1.0,
    qscale: float = 4.0,
) -> jnp.ndarray:
    """Normalized/offset min-sum check update on the general path:
    |out| = max(α_d · min_{other} |m| − β, 0), numerics in lockstep with
    qc_decode.cn_update_qc_minsum (messages stay in the LLR domain;
    int8 messages are fixed-point at ``qscale``)."""
    is_q = msgs_c.dtype == jnp.int8
    out = []
    syn_i = syn.astype(jnp.int32)
    for b in tables.cn_buckets:
        m = _bucket_view(msgs_c, b)
        m = (dequantize_msgs(m, qscale) if is_q
             else m.astype(jnp.float32))  # [count, d, B]
        neg = jnp.signbit(m)
        a = jnp.abs(m)
        min1 = jnp.min(a, axis=1, keepdims=True)
        pos = jnp.argmin(a, axis=1, keepdims=True)  # first minimum
        k_idx = jnp.arange(b.degree)[None, :, None]
        a_excl = jnp.where(k_idx == pos, jnp.inf, a)
        min2 = jnp.min(a_excl, axis=1, keepdims=True)
        if b.degree == 1:
            # sole edge: empty leave-one-out (see cn_update_qc_minsum)
            min2 = jnp.zeros_like(min2)
        other = jnp.where(k_idx == pos, min2, min1)
        a_g = resolve_minsum_alpha(alpha, b.degree)
        res = jnp.maximum(jnp.float32(a_g) * other - jnp.float32(beta), 0.0)
        pos_votes = jnp.sum(1 - neg.astype(jnp.int32), axis=1, keepdims=True)
        s = syn_i[b.row_start : b.row_start + b.count][:, None, :]
        parity = (s + pos_votes) & 1
        is_neg = (neg.astype(jnp.int32) ^ parity) == 1
        rf = jnp.where(is_neg, -res, res)
        r = quantize_msgs(rf, qscale) if is_q else rf.astype(msgs_c.dtype)
        out.append(r.reshape(b.count * b.degree, -1))
    return jnp.concatenate(out, axis=0)


def vn_update_minsum(
    r_v: jnp.ndarray,  # [E, B] CN→VN messages, vn-edge order
    llr: jnp.ndarray,  # [n_vars, B] sorted order
    tables: DecodeTables,
    clamp: float,
    qscale: float = 4.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Min-sum variable update: leave-one-out sums, clamped (twin of
    qc_decode.vn_update_qc_minsum).
    Returns (new msgs in vn-edge order, totals [n_vars, B] f32)."""
    is_q = r_v.dtype == jnp.int8
    msgs_out, totals_out = [], []
    for b in tables.vn_buckets:
        r = _bucket_view(r_v, b)
        r = dequantize_msgs(r, qscale) if is_q else r.astype(jnp.float32)
        lv = llr[b.row_start : b.row_start + b.count].astype(jnp.float32)
        totals = lv + jnp.sum(r, axis=1)
        if b.degree == 1:
            # sole edge: emit clip(llr) exactly, not totals - r (low-order
            # rounding differs) — matches the QC paths' d==1 branch
            pre = lv[:, None]
        else:
            pre = totals[:, None, :] - r
        mf = jnp.clip(pre, -clamp, clamp)
        m = quantize_msgs(mf, qscale) if is_q else mf.astype(r_v.dtype)
        msgs_out.append(m.reshape(b.count * b.degree, -1))
        totals_out.append(totals)
    return jnp.concatenate(msgs_out, axis=0), jnp.concatenate(totals_out,
                                                              axis=0)


def bp_iteration_minsum(
    msgs_c: jnp.ndarray,
    llr: jnp.ndarray,
    syn: jnp.ndarray,
    tables: DecodeTables,
    beta: float = 0.0,
    clamp: float = 64.0,
    alpha=1.0,
    qscale: float = 4.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One min-sum flood iteration in cn-edge-order state. Unlike
    bp_iteration's fused gather-totals formulation, the VN pass runs in
    vn-edge order (bucket views) so the degree-1 special case and the
    f32 op sequence match the QC paths bit-for-bit; the result is
    permuted back to cn order with perm_v2c."""
    r_c = cn_update_minsum(msgs_c, syn, tables, beta, alpha, qscale)
    r_v = jnp.take(r_c, tables.perm_c2v, axis=0)
    m_v, totals = vn_update_minsum(r_v, llr, tables, clamp, qscale)
    return jnp.take(m_v, tables.perm_v2c, axis=0), totals


def init_messages(
    llr: jnp.ndarray, tables: DecodeTables, dtype=jnp.float32,
    phi_pre: float = PRE_THRESHOLD, alg: str = "sum-product",
    clamp: float = 64.0, qscale: float = 4.0,
) -> jnp.ndarray:
    """Fresh-frame message init: every edge of a variable gets φ(llr) for
    sum-product, llr itself for min-sum — quantized for int8 storage
    (flood_refill, flood.cu:297-323; qc_decode.init_messages_qc). [E, B]."""
    if alg == "min-sum":
        if dtype == jnp.int8:
            p = quantize_msgs(
                jnp.clip(llr.astype(jnp.float32), -clamp, clamp), qscale)
        else:
            p = llr.astype(dtype)
    else:
        p = jnp.copysign(phi_abs(jnp.abs(llr), phi_pre), llr)
    return jnp.take(p, tables.cn_edge_vnrow, axis=0).astype(dtype)


def hard_bits(totals: jnp.ndarray) -> jnp.ndarray:
    """LLR >= +0 ⇔ bit 1, honoring the sign of zero (flood.cu:180)."""
    return (~jnp.signbit(totals)).astype(jnp.int8)


@partial(jax.jit, static_argnames=("k", "phi_pre", "alg", "beta", "clamp",
                                   "alpha", "qscale"))
def run_iterations(
    msgs_c: jnp.ndarray,
    llr: jnp.ndarray,
    syn: jnp.ndarray,
    tables: DecodeTables,
    k: int,
    phi_pre: float = PRE_THRESHOLD,
    alg: str = "sum-product",
    beta: float = 0.0,
    clamp: float = 64.0,
    alpha=1.0,
    qscale: float = 4.0,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """k flood iterations then a parity check.

    Returns (msgs_c, bits [n_vars, B] int8 sorted order, violated [B] bool).
    The analog of the reference's hot loop segment between host
    convergence polls (ldpc_decoder_gpu.cu:346-374). ``alg``:
    "sum-product" (exact φ chain) or "min-sum" (normalized/offset
    two-minimum; β/α/clamp/qscale as in StaticParams)."""

    def body(_, carry):
        msgs, _ = carry
        if alg == "min-sum":
            return bp_iteration_minsum(msgs, llr, syn, tables, beta, clamp,
                                       alpha, qscale)
        return bp_iteration(msgs, llr, syn, tables, phi_pre)

    totals0 = jnp.zeros((tables.n_vars, llr.shape[-1]), jnp.float32)
    msgs_c, totals = jax.lax.fori_loop(0, k, body, (msgs_c, totals0))
    bits = hard_bits(totals)
    violated = parity_violations(bits, syn, tables)
    return msgs_c, bits, violated


@partial(jax.jit, static_argnames=("b", "phi_pre", "alg", "beta", "clamp",
                                   "alpha", "qscale"))
def burst_iterations(
    msgs_c: jnp.ndarray,
    llr: jnp.ndarray,
    syn: jnp.ndarray,
    tables: DecodeTables,
    b: int,
    phi_pre: float = PRE_THRESHOLD,
    alg: str = "sum-product",
    beta: float = 0.0,
    clamp: float = 64.0,
    alpha=1.0,
    qscale: float = 4.0,
) -> jnp.ndarray:
    """``b`` plain flood iterations, no parity check — bit-identical prefix
    of run_iterations (the delayed-first-parity-check phase,
    DynamicParams.num_iter_first_check)."""

    def body(_, carry):
        msgs, _ = carry
        if alg == "min-sum":
            return bp_iteration_minsum(msgs, llr, syn, tables, beta, clamp,
                                       alpha, qscale)
        return bp_iteration(msgs, llr, syn, tables, phi_pre)

    totals0 = jnp.zeros((tables.n_vars, llr.shape[-1]), jnp.float32)
    msgs_c, _ = jax.lax.fori_loop(0, b, body, (msgs_c, totals0))
    return msgs_c
