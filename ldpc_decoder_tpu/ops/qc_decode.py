"""Flood BP decode on quasi-cyclic codes: rotations instead of gathers.

Same algorithm as ops/decode.py (φ-domain messages, abs-sum/sign-parity
check update, leave-one-out variable update — flood.cu:77-223), but the
Tanner-graph edge permutation is realized as per-circulant cyclic rotations:

- messages live in [n_blocks, Z, B] arrays (Z = circulant size, B frames on
  lanes); check-order blocks are grouped by base-row degree, variable-order
  blocks by base-column degree, so both node updates are dense
  reshape+reduce;
- check-order block t (row r, col c, shift s) holds, at sublane z, the edge
  (check (r,z) <-> var (c, (z+s) mod Z)); moving it to variable order is
  roll(+s), moving back is roll(-s) — no gathers anywhere.

This module is the jnp/XLA implementation (and the correctness oracle);
ops/qc_triton.py fuses the same math into Pallas kernels for the GPU.

The 2-D state interface (msgs [E, B], llr [n_vars, B], syn [n_checks, B] in
block-sorted order) matches ops/decode.py, so the decoder runtime drives
either path unchanged — [E, B] reshapes to [n_blocks, Z, B] for free.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_decoder_tpu.codes.qc import QCStructure
from ldpc_decoder_tpu.ops.phi import PRE_THRESHOLD, phi_abs


@dataclasses.dataclass(frozen=True)
class BlockGroup:
    degree: int
    count: int  # number of base nodes (rows or cols) of this degree
    block_start: int  # first block index in the sorted block order


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "cn_shift",
        "vn_of_cn",
        "cn_of_vn",
        "vn_shift",
        "cn_col_of_block",
        "vn_pos",
        "vn_order",
        "cn_order",
        "erased_mask_sorted",
    ],
    meta_fields=["n_vars", "n_checks", "n_edges", "Z", "n_blocks",
                 "row_groups", "col_groups"],
)
@dataclasses.dataclass(frozen=True)
class QCDecodeTables:
    """Device-resident constants of one compiled QC code."""

    n_vars: int
    n_checks: int
    n_edges: int
    Z: int
    n_blocks: int  # base edges
    row_groups: tuple[BlockGroup, ...]  # over check-order blocks
    col_groups: tuple[BlockGroup, ...]  # over variable-order blocks

    cn_shift: jnp.ndarray  # [n_blocks] shift of check-order block t
    vn_of_cn: jnp.ndarray  # [n_blocks] vn-block index of cn block t
    cn_of_vn: jnp.ndarray  # [n_blocks] inverse
    vn_shift: jnp.ndarray  # [n_blocks] shift of vn-order block u (= its cn's)
    cn_col_of_block: jnp.ndarray  # [n_blocks] sorted col row-index of block t

    # 2-D interface compatibility (pool permutes, packing, erasures)
    vn_pos: jnp.ndarray  # [n_vars]
    vn_order: jnp.ndarray  # [n_vars]
    cn_order: jnp.ndarray  # [n_checks]
    erased_mask_sorted: jnp.ndarray  # [n_vars, 1] bool

    @staticmethod
    def from_structure(
        s: QCStructure, n_erased_vars: int = 0
    ) -> "QCDecodeTables":
        Z = s.Z
        row_deg = s.row_degrees()
        col_deg = s.col_degrees()
        # sorted node orders (by degree, stable)
        row_order = np.argsort(row_deg, kind="stable")
        col_order = np.argsort(col_deg, kind="stable")
        row_pos = np.empty_like(row_order)
        row_pos[row_order] = np.arange(len(row_order))
        col_pos = np.empty_like(col_order)
        col_pos[col_order] = np.arange(len(col_order))

        # check-order blocks: sort base edges by (row_pos, col); vn-order
        # blocks by (col_pos, row)
        cn_key = np.lexsort((s.edge_col, row_pos[s.edge_row]))
        vn_key = np.lexsort((s.edge_row, col_pos[s.edge_col]))
        nb = s.n_base_edges
        vn_rank = np.empty(nb, dtype=np.int64)
        vn_rank[vn_key] = np.arange(nb)
        vn_of_cn = vn_rank[cn_key].astype(np.int32)
        cn_of_vn = np.empty(nb, dtype=np.int32)
        cn_of_vn[vn_of_cn] = np.arange(nb, dtype=np.int32)
        cn_shift = s.edge_shift[cn_key].astype(np.int32)
        vn_shift = cn_shift[cn_of_vn]
        cn_col_of_block = col_pos[s.edge_col[cn_key]].astype(np.int32)

        def groups(sorted_deg):
            degs, starts, counts = np.unique(
                sorted_deg, return_index=True, return_counts=True
            )
            out, blk = [], 0
            for d, c in zip(degs.tolist(), counts.tolist()):
                out.append(BlockGroup(degree=int(d), count=int(c),
                                      block_start=blk))
                blk += int(d) * int(c)
            return tuple(out)

        # block-expanded 2-D orders: sorted var row i*Z+z -> natural
        # col_order[i]*Z+z
        z = np.arange(Z, dtype=np.int64)
        vn_order2 = (
            col_order.astype(np.int64)[:, None] * Z + z[None, :]
        ).reshape(-1)
        cn_order2 = (
            row_order.astype(np.int64)[:, None] * Z + z[None, :]
        ).reshape(-1)
        vn_pos2 = np.empty_like(vn_order2)
        vn_pos2[vn_order2] = np.arange(vn_order2.shape[0])

        erased_nat = np.zeros(s.n_base_cols * Z, dtype=bool)
        if n_erased_vars:
            erased_nat[s.n_base_cols * Z - n_erased_vars :] = True

        return QCDecodeTables(
            n_vars=s.n_base_cols * Z,
            n_checks=s.n_base_rows * Z,
            n_edges=nb * Z,
            Z=Z,
            n_blocks=nb,
            row_groups=groups(row_deg[row_order]),
            col_groups=groups(col_deg[col_order]),
            cn_shift=jnp.asarray(cn_shift),
            vn_of_cn=jnp.asarray(vn_of_cn),
            cn_of_vn=jnp.asarray(cn_of_vn),
            vn_shift=jnp.asarray(vn_shift),
            cn_col_of_block=jnp.asarray(cn_col_of_block),
            vn_pos=jnp.asarray(vn_pos2.astype(np.int32)),
            vn_order=jnp.asarray(vn_order2.astype(np.int32)),
            cn_order=jnp.asarray(cn_order2.astype(np.int32)),
            erased_mask_sorted=jnp.asarray(erased_nat[vn_order2])[:, None],
        )


def _roll_blocks(x: jnp.ndarray, shifts: jnp.ndarray) -> jnp.ndarray:
    """Per-block cyclic rotation: out[t] = roll(x[t], shifts[t], axis=0)."""
    return jax.vmap(lambda xb, sb: jnp.roll(xb, sb, axis=0))(x, shifts)


def cn_to_vn(r_c: jnp.ndarray, tables: QCDecodeTables) -> jnp.ndarray:
    """[nb, Z, B] check-order -> variable-order (roll +s, permute blocks)."""
    rolled = _roll_blocks(r_c, tables.cn_shift)
    return jnp.take(rolled, tables.cn_of_vn, axis=0)


def vn_to_cn(m_v: jnp.ndarray, tables: QCDecodeTables) -> jnp.ndarray:
    """[nb, Z, B] variable-order -> check-order (permute blocks, roll -s)."""
    picked = jnp.take(m_v, tables.vn_of_cn, axis=0)
    return _roll_blocks(picked, -tables.cn_shift)


def cn_update_qc(
    msgs: jnp.ndarray,  # [nb, Z, B] φ-domain messages, check order
    syn: jnp.ndarray,  # [R, Z, B] int8, sorted row order
    tables: QCDecodeTables,
    phi_pre: float = PRE_THRESHOLD,
) -> jnp.ndarray:
    out = []
    syn_i = syn.astype(jnp.int32)
    row = 0
    for g in tables.row_groups:
        nbk = g.count * g.degree
        start = g.block_start
        m = msgs[start : start + nbk].reshape(
            g.count, g.degree, tables.Z, -1
        ).astype(jnp.float32)
        neg = jnp.signbit(m)
        a = jnp.abs(m)
        ext = jnp.sum(a, axis=1, keepdims=True)
        pos_votes = jnp.sum(1 - neg.astype(jnp.int32), axis=1, keepdims=True)
        sblk = syn_i[row : row + g.count][:, None]
        parity = (sblk + pos_votes) & 1
        res = phi_abs(ext - a, phi_pre)
        is_neg = (neg.astype(jnp.int32) ^ parity) == 1
        r = jnp.where(is_neg, -res, res).astype(msgs.dtype)
        out.append(r.reshape(nbk, tables.Z, -1))
        row += g.count
    return jnp.concatenate(out, axis=0)


def vn_update_qc(
    r_v: jnp.ndarray,  # [nb, Z, B] variable-order CN->VN messages
    llr: jnp.ndarray,  # [C, Z, B] sorted col order
    tables: QCDecodeTables,
    phi_pre: float = PRE_THRESHOLD,
    fresh=None,  # [B] bool: lane was just refilled — emit init values
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (new variable-order messages [nb, Z, B], totals [C, Z, B]).

    ``fresh`` marks lanes whose message state is stale (the frame was
    retired and the lane refilled with a new frame's LLRs but the edge
    arrays were NOT re-initialized — the lane-reset refill scheme,
    runtime/decoder.py). For those lanes the leave-one-out sum is replaced
    by the bare channel LLR, which makes this update emit exactly the
    init message φ(llr) — resetting the lane in-kernel instead of paying
    a full init+merge pass over the edge arrays.
    """
    msgs_out, totals_out = [], []
    col = 0
    for g in tables.col_groups:
        nbk = g.count * g.degree
        start = g.block_start
        r = r_v[start : start + nbk].reshape(
            g.count, g.degree, tables.Z, -1
        ).astype(jnp.float32)
        lv = llr[col : col + g.count].astype(jnp.float32)
        totals = lv + jnp.sum(r, axis=1)
        if g.degree == 1:
            # sole edge: the leave-one-out sum is exactly the channel LLR.
            # Emit φ(llr) directly (not φ((llr+r)-r), which can differ in
            # low-order f32 bits when llr+r rounds) so the grouped kernels'
            # degree-1 launch skip — which retains the φ(llr) init value —
            # stays bit-identical to this oracle.
            pre = lv[:, None]
        else:
            pre = totals[:, None] - r
            if fresh is not None:
                pre = jnp.where(fresh[None, None, None, :], lv[:, None], pre)
        m = jnp.copysign(phi_abs(jnp.abs(pre), phi_pre), pre).astype(r_v.dtype)
        if fresh is not None:
            totals = jnp.where(fresh[None, None, :], lv, totals)
        msgs_out.append(m.reshape(nbk, tables.Z, -1))
        totals_out.append(totals)
        col += g.count
    return jnp.concatenate(msgs_out, axis=0), jnp.concatenate(totals_out)


def parity_violations_qc(
    bits: jnp.ndarray,  # [C, Z, B] int8, sorted col order
    syn: jnp.ndarray,  # [R, Z, B] int8, sorted row order
    tables: QCDecodeTables,
) -> jnp.ndarray:
    """[B] bool — any violated check per frame (check_parity analog)."""
    bits_blocks = jnp.take(bits, tables.cn_col_of_block, axis=0)
    bits_c = _roll_blocks(bits_blocks, -tables.cn_shift)
    viol = []
    row = 0
    for g in tables.row_groups:
        nbk = g.count * g.degree
        x = jnp.sum(
            bits_c[g.block_start : g.block_start + nbk]
            .reshape(g.count, g.degree, tables.Z, -1)
            .astype(jnp.int32),
            axis=1,
        )
        s = syn[row : row + g.count].astype(jnp.int32)
        viol.append(jnp.any(((x + s) & 1) > 0, axis=(0, 1)))
        row += g.count
    return jnp.any(jnp.stack(viol), axis=0)  # [B]


def syndrome_from_bits_qc(
    bits2d: jnp.ndarray, tables: QCDecodeTables
) -> jnp.ndarray:
    """[n_checks, B] syndrome from sorted 2-D bits."""
    Z = tables.Z
    bits = bits2d.reshape(-1, Z, bits2d.shape[-1])
    bits_blocks = jnp.take(bits, tables.cn_col_of_block, axis=0)
    bits_c = _roll_blocks(bits_blocks, -tables.cn_shift)
    out = []
    for g in tables.row_groups:
        nbk = g.count * g.degree
        x = jnp.sum(
            bits_c[g.block_start : g.block_start + nbk]
            .reshape(g.count, g.degree, Z, -1)
            .astype(jnp.int32),
            axis=1,
        )
        out.append((x & 1).astype(jnp.int8))
    return jnp.concatenate(out).reshape(tables.n_checks, -1)


def quantize_msgs(x: jnp.ndarray, qscale: float) -> jnp.ndarray:
    """f32 LLR messages -> int8 fixed-point at ``qscale`` steps/unit.

    Standard hardware min-sum quantization (the min/sign/±β update is
    exact on the integer grid): round-to-nearest-even, saturate at ±127 —
    i.e. a built-in symmetric clamp of 127/qscale (±31.75 at the default
    scale 4). Zero keeps no sign, which is information-free in the
    LLR domain (a 0-magnitude input forces 0-magnitude check outputs)."""
    return jnp.clip(jnp.round(x.astype(jnp.float32) * jnp.float32(qscale)),
                    -127.0, 127.0).astype(jnp.int8)


def dequantize_msgs(m: jnp.ndarray, qscale: float) -> jnp.ndarray:
    return m.astype(jnp.float32) * jnp.float32(1.0 / qscale)


def resolve_minsum_alpha(alpha, degree: int) -> float:
    """Per-degree normalization factor of normalized min-sum.

    ``alpha`` is either a scalar (uniform α) or a hashable tuple of
    ``(degree, α)`` pairs — degree-matched normalization, the standard
    refinement for irregular codes (each check degree d has its own
    E[min of d-1 |LLR|s] bias; a single α over-corrects some degrees).
    A ``(0, α)`` pair is the fallback for degrees not listed.
    """
    if isinstance(alpha, (int, float)):
        return float(alpha)
    table = dict(alpha)
    if degree in table:
        return float(table[degree])
    if 0 in table:
        return float(table[0])
    raise ValueError(
        f"minsum alpha table {alpha!r} has no entry for check degree "
        f"{degree} and no (0, default) fallback")


def cn_update_qc_minsum(
    msgs: jnp.ndarray,  # [nb, Z, B] LLR-domain messages, check order
    syn: jnp.ndarray,  # [R, Z, B] int8, sorted row order
    tables: QCDecodeTables,
    beta: float,
    alpha=1.0,
    qscale: float = 4.0,
) -> jnp.ndarray:
    """Normalized/offset min-sum check update:
    |out| = max(α_d · min_{other} |m| - β, 0).

    The standard hardware-decoder approximation of the tanh rule (replaces
    the reference's φ chain, flood.cu:88-114, with a two-minimum
    leave-one-out); messages stay in the LLR domain. ``alpha`` may be
    per-check-degree (see resolve_minsum_alpha). int8 messages are
    fixed-point at ``qscale`` (quantize_msgs).
    """
    is_q = msgs.dtype == jnp.int8
    out = []
    syn_i = syn.astype(jnp.int32)
    row = 0
    for g in tables.row_groups:
        nbk = g.count * g.degree
        start = g.block_start
        m = msgs[start : start + nbk].reshape(
            g.count, g.degree, tables.Z, -1
        )
        m = dequantize_msgs(m, qscale) if is_q else m.astype(jnp.float32)
        neg = jnp.signbit(m)
        a = jnp.abs(m)
        min1 = jnp.min(a, axis=1, keepdims=True)
        pos = jnp.argmin(a, axis=1, keepdims=True)  # first minimum
        k_idx = jnp.arange(g.degree)[None, :, None, None]
        a_excl = jnp.where(k_idx == pos, jnp.inf, a)
        min2 = jnp.min(a_excl, axis=1, keepdims=True)
        if g.degree == 1:
            # sole edge: the leave-one-out set is empty; mirror the
            # kernels' d==1 special case (qc_triton._cn_kernel)
            # so oracle and kernel stay bit-identical (inf would NaN the
            # VN pass via inf - inf)
            min2 = jnp.zeros_like(min2)
        other = jnp.where(k_idx == pos, min2, min1)
        a_g = resolve_minsum_alpha(alpha, g.degree)
        res = jnp.maximum(jnp.float32(a_g) * other - jnp.float32(beta), 0.0)
        pos_votes = jnp.sum(1 - neg.astype(jnp.int32), axis=1, keepdims=True)
        sblk = syn_i[row : row + g.count][:, None]
        parity = (sblk + pos_votes) & 1
        is_neg = (neg.astype(jnp.int32) ^ parity) == 1
        rf = jnp.where(is_neg, -res, res)
        r = quantize_msgs(rf, qscale) if is_q else rf.astype(msgs.dtype)
        out.append(r.reshape(nbk, tables.Z, -1))
        row += g.count
    return jnp.concatenate(out, axis=0)


def vn_update_qc_minsum(
    r_v: jnp.ndarray,  # [nb, Z, B] variable-order CN->VN messages
    llr: jnp.ndarray,  # [C, Z, B] sorted col order
    tables: QCDecodeTables,
    clamp: float,
    fresh=None,  # [B] bool: lane-reset refill (see vn_update_qc)
    qscale: float = 4.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Min-sum variable update: plain leave-one-out sums, clamped.
    int8 messages are re-quantized on write (quantize_msgs)."""
    is_q = r_v.dtype == jnp.int8
    msgs_out, totals_out = [], []
    col = 0
    for g in tables.col_groups:
        nbk = g.count * g.degree
        start = g.block_start
        r = r_v[start : start + nbk].reshape(
            g.count, g.degree, tables.Z, -1
        )
        r = dequantize_msgs(r, qscale) if is_q else r.astype(jnp.float32)
        lv = llr[col : col + g.count].astype(jnp.float32)
        totals = lv + jnp.sum(r, axis=1)
        if g.degree == 1:
            # sole edge: emit clip(llr) exactly (see vn_update_qc) so the
            # grouped kernels' degree-1 launch skip stays bit-identical
            pre = lv[:, None]
        else:
            pre = totals[:, None] - r
            if fresh is not None:
                pre = jnp.where(fresh[None, None, None, :], lv[:, None], pre)
        mf = jnp.clip(pre, -clamp, clamp)
        m = quantize_msgs(mf, qscale) if is_q else mf.astype(r_v.dtype)
        if fresh is not None:
            totals = jnp.where(fresh[None, None, :], lv, totals)
        msgs_out.append(m.reshape(nbk, tables.Z, -1))
        totals_out.append(totals)
        col += g.count
    return jnp.concatenate(msgs_out, axis=0), jnp.concatenate(totals_out)


def bp_iteration_qc(msgs, llr, syn, tables, alg="sum-product", beta=0.0,
                    clamp=64.0, phi_pre=PRE_THRESHOLD, fresh=None,
                    alpha=1.0, qscale=4.0):
    """One flood iteration in QC layout. msgs check-order [nb, Z, B]."""
    if alg == "min-sum":
        r_c = cn_update_qc_minsum(msgs, syn, tables, beta, alpha, qscale)
        r_v = cn_to_vn(r_c, tables)
        m_v, totals = vn_update_qc_minsum(r_v, llr, tables, clamp, fresh,
                                          qscale)
    else:
        r_c = cn_update_qc(msgs, syn, tables, phi_pre)
        r_v = cn_to_vn(r_c, tables)
        m_v, totals = vn_update_qc(r_v, llr, tables, phi_pre, fresh)
    return vn_to_cn(m_v, tables), totals


def init_messages_qc(llr2d, tables, dtype=jnp.float32, alg="sum-product",
                     phi_pre=PRE_THRESHOLD, clamp=64.0, qscale=4.0):
    """[E, B] fresh messages, rotated into check order (flood_refill
    analog): φ(llr) for sum-product, llr itself for min-sum (quantized
    for int8 message storage)."""
    Z = tables.Z
    llr = llr2d.reshape(-1, Z, llr2d.shape[-1])
    if alg == "min-sum":
        if dtype == jnp.int8:
            p = quantize_msgs(
                jnp.clip(llr.astype(jnp.float32), -clamp, clamp), qscale)
        else:
            p = llr.astype(dtype)
    else:
        p = jnp.copysign(phi_abs(jnp.abs(llr), phi_pre), llr).astype(dtype)
    blocks = jnp.take(p, tables.cn_col_of_block, axis=0)
    m_c = _roll_blocks(blocks, -tables.cn_shift)
    return m_c.reshape(tables.n_edges, -1)


@partial(jax.jit, static_argnames=("b", "alg", "beta", "clamp", "phi_pre",
                                   "alpha", "qscale"))
def burst_iterations_qc(msgs2d, llr2d, syn2d, tables: QCDecodeTables,
                        b: int, alg: str = "sum-product", beta: float = 0.0,
                        clamp: float = 64.0,
                        phi_pre: float = PRE_THRESHOLD, alpha=1.0,
                        qscale: float = 4.0):
    """``b`` plain BP iterations, no emit / no parity — bit-identical
    prefix of run_iterations_qc (the delayed-first-parity-check phase;
    DynamicParams.num_iter_first_check)."""
    B = msgs2d.shape[-1]
    Z = tables.Z
    msgs = msgs2d.reshape(tables.n_blocks, Z, B)
    llr = llr2d.reshape(-1, Z, B)
    syn = syn2d.reshape(-1, Z, B)

    def body(_, carry):
        m, _ = carry
        return bp_iteration_qc(m, llr, syn, tables, alg, beta, clamp,
                               phi_pre, alpha=alpha, qscale=qscale)

    msgs, _ = jax.lax.fori_loop(
        0, b, body, (msgs, jnp.zeros(llr.shape, jnp.float32)))
    return msgs.reshape(tables.n_edges, B)


@partial(jax.jit, static_argnames=("k", "alg", "beta", "clamp", "phi_pre",
                                   "alpha", "qscale"))
def run_iterations_qc(msgs2d, llr2d, syn2d, tables: QCDecodeTables, k: int,
                      alg: str = "sum-product", beta: float = 0.0,
                      clamp: float = 64.0, phi_pre: float = PRE_THRESHOLD,
                      fresh=None, alpha=1.0, qscale: float = 4.0):
    """2-D-interface twin of ops.decode.run_iterations.

    ``fresh`` ([B] bool/int8 or None): lanes refilled since the last
    superstep — their stale messages are reset in-kernel on the FIRST
    iteration (vn_update_qc); iterations 2..k then run normally.
    """
    B = msgs2d.shape[-1]
    Z = tables.Z
    msgs = msgs2d.reshape(tables.n_blocks, Z, B)
    llr = llr2d.reshape(-1, Z, B)
    syn = syn2d.reshape(-1, Z, B)

    def body(_, carry):
        m, _ = carry
        return bp_iteration_qc(m, llr, syn, tables, alg, beta, clamp,
                               phi_pre, alpha=alpha, qscale=qscale)

    totals0 = jnp.zeros(llr.shape, jnp.float32)
    if fresh is None:
        msgs, totals = jax.lax.fori_loop(0, k, body, (msgs, totals0))
    else:
        fr = fresh.reshape(-1) != 0
        msgs, totals = bp_iteration_qc(msgs, llr, syn, tables, alg, beta,
                                       clamp, phi_pre, fresh=fr, alpha=alpha,
                                       qscale=qscale)
        msgs, totals = jax.lax.fori_loop(1, k, body, (msgs, totals))
    bits = (~jnp.signbit(totals)).astype(jnp.int8)
    violated = parity_violations_qc(bits, syn, tables)
    return (
        msgs.reshape(tables.n_edges, B),
        bits.reshape(tables.n_vars, B),
        violated,
    )
