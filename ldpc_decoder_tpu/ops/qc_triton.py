"""Fused QC-LDPC node updates for NVIDIA GPUs (Pallas on Triton).

Same math as the XLA oracle in ops/qc_decode.py, but each pass reads every
edge message once and writes it once:

- ``msgs_v [nb, Z, B]`` holds the variable->check messages in variable
  order (blocks sorted by column, then row), written aligned by the VN pass;
- ``r_c [nb, Z, B]`` holds the check->variable messages in check order,
  written aligned by the CN pass.

A circulant rotation is only an index: slot t of check row r reads rows
``(z + s_t) mod Z`` of its variable-order source block, and each row is B
contiguous frame lanes, so the loads of a ``[T, LB]`` tile coalesce. The
XLA path instead materializes a rolled copy per block, a block permute and
f32 temporaries between the degree sum and φ.

One ``pallas_call`` per pass covers every degree group: program
``(node, z-tile, lane-block)`` branches to its group's unrolled degree, loads
its own shift/source tables (no scalar prefetch), and keeps the d rotated
tiles in registers. The VN pass aliases the previous ``msgs_v`` as its
output, so degree-1 columns — whose outgoing message φ(llr) never changes —
are skipped on non-emit iterations and keep their init values.

``interpret=True`` runs the kernels through the Pallas interpreter; it is
reached only from tests (StaticParams.pallas_interpret). On the CPU the
interpreter and the oracle both evaluate through XLA:CPU, so the two agree
bit for bit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ldpc_decoder_tpu.ops.phi import PRE_THRESHOLD, phi_abs
from ldpc_decoder_tpu.ops.qc_decode import (
    QCDecodeTables,
    parity_violations_qc,
    quantize_msgs,
    resolve_minsum_alpha,
)

# message dtypes the kernels take; float8_e5m2 stays on the XLA path
DTYPES = ("float32", "bfloat16", "int8")

# bound on tile elements x degree per program (the d input tiles live in
# registers); with four warps, 16 f32 values per thread. Swept on an H100
# (PERF.md): 8192 spills and runs 1.3x slower, 1024-4096 are within 4%
_REG_ELEMS = 2048
_MAX_LANES = 256
_NUM_WARPS = 4
_SIGN = 0x80000000


def _pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two that divides ``n`` and is at most ``cap``."""
    p = 1
    while p * 2 <= cap and n % (p * 2) == 0:
        p *= 2
    return p


def tile_config(d_max: int, Z: int, B: int) -> tuple[int, int]:
    """(T rows, LB lanes) of one program's tile: lanes as wide as B allows
    (up to 256, each row a contiguous run), rows bounded by the register
    budget of d_max live tiles. Both are powers of two dividing Z and B."""
    lb = _pow2_divisor(B, _MAX_LANES)
    t = _pow2_divisor(Z, max(1, _REG_ELEMS // (d_max * lb)))
    return t, lb


def _groups_with_nodes(groups):
    """(node_start, count, degree, block_start) per degree group."""
    out, node = [], 0
    for g in groups:
        out.append((node, g.count, g.degree, g.block_start))
        node += g.count
    return tuple(out)


def _load(ref, idx, qscale: float):
    x = ref[idx].astype(jnp.float32)
    return x * jnp.float32(1.0 / qscale) if ref.dtype == jnp.int8 else x


def _store(ref, idx, val, qscale: float):
    """Write a message tile; int8 is fixed point at ``qscale`` steps per
    unit, saturated at ±127 (ops/qc_decode.quantize_msgs)."""
    if ref.dtype == jnp.int8:
        # round half to even from the truncation and its exact remainder
        # (Triton has no round primitive)
        v = jnp.clip(val * jnp.float32(qscale), -127.0, 127.0)
        t = v.astype(jnp.int32)
        f = v - t.astype(jnp.float32)
        odd = (t & 1) == 1
        up = (f > 0.5) | ((f == 0.5) & odd)
        down = (f < -0.5) | ((f == -0.5) & odd)
        q = t + up.astype(jnp.int32) - down.astype(jnp.int32)
        ref[idx] = q.astype(jnp.int8)
    else:
        ref[idx] = val.astype(ref.dtype)


def _tile_origin(T: int, LB: int):
    """First row and the lane slice of this program's tile. The alignment
    hints let Triton vectorize the lane-contiguous loads and stores."""
    z0 = pl.multiple_of(pl.program_id(1) * T, T)
    return z0, pl.ds(pl.multiple_of(pl.program_id(2) * LB, LB), LB)


def _rotated_rows(z, s, Z: int, forward: bool):
    """Rows (z + s) mod Z (forward) or (z - s) mod Z, for s in [0, Z)."""
    if forward:
        r = z + s
        return jnp.where(r >= Z, r - Z, r)
    r = z - s
    return jnp.where(r < 0, r + Z, r)


def _cn_kernel(src_ref, shift_ref, msgs_ref, syn_ref, out_ref, *, groups,
               Z: int, T: int, LB: int, alg: str, beta: float, alpha,
               phi_pre: float, qscale: float):
    """Check-node update of one (row, z-tile, lane-block) program."""
    row = pl.program_id(0)
    z0, lanes = _tile_origin(T, LB)
    z = z0 + jax.lax.broadcasted_iota(jnp.int32, (T,), 0)
    aligned = pl.ds(z0, T)

    def group(node_start, d, block_start):
        base = block_start + (row - node_start) * d
        m = []
        for k in range(d):
            rows = _rotated_rows(z, shift_ref[base + k], Z, True)
            m.append(_load(msgs_ref, (src_ref[base + k], rows, lanes),
                           qscale))
        a = [jnp.abs(x) for x in m]
        # parity sign of output k: syndrome ⊕ (d mod 2) ⊕ all input sign
        # bits ⊕ its own sign bit — the oracle's vote count mod 2
        u32 = jnp.uint32
        sb = [jax.lax.bitcast_convert_type(x, u32) & u32(_SIGN) for x in m]
        X = syn_ref[row, aligned, lanes].astype(u32) << 31
        if d % 2:
            X = X ^ u32(_SIGN)
        for b in sb:
            X = X ^ b
        if alg == "min-sum":
            m1 = a[0]
            m2 = jnp.full_like(a[0], jnp.inf)
            pos = jnp.zeros(a[0].shape, jnp.int32)
            for k in range(1, d):
                is_new = a[k] < m1
                m2 = jnp.where(is_new, m1, jnp.minimum(m2, a[k]))
                m1 = jnp.where(is_new, a[k], m1)
                pos = jnp.where(is_new, k, pos)
            if d == 1:
                m2 = jnp.zeros_like(m1)  # sole edge: empty leave-one-out
            a_d = jnp.float32(resolve_minsum_alpha(alpha, d))
            res = [jnp.maximum(a_d * jnp.where(pos == k, m2, m1)
                               - jnp.float32(beta), 0.0) for k in range(d)]
        else:
            ext = a[0]
            for x in a[1:]:
                ext = ext + x
            res = [phi_abs(ext - a[k], phi_pre) for k in range(d)]
        for k in range(d):
            # res >= 0 has a clear sign bit: OR installs the parity sign
            signed = jax.lax.bitcast_convert_type(
                jax.lax.bitcast_convert_type(res[k], u32) | (sb[k] ^ X),
                jnp.float32)
            _store(out_ref, (base + k, aligned, lanes), signed, qscale)

    for node_start, count, d, block_start in groups:
        pl.when((row >= node_start) & (row < node_start + count))(
            partial(group, node_start, d, block_start))


def _vn_kernel(src_ref, shift_ref, r_ref, llr_ref, *refs, groups, col0: int,
               Z: int, T: int, LB: int, alg: str, clamp: float,
               phi_pre: float, qscale: float, emit_bits: bool,
               with_fresh: bool):
    """Variable-node update of one (column, z-tile, lane-block) program.

    refs = (fresh [B] int8)?, msgs_prev (aliased, unread), msgs_out,
    (bits [C, Z, B] int8)?. ``with_fresh`` lanes were refilled: their
    messages are a retired frame's, so they emit the init message (the
    bare channel LLR replaces the leave-one-out sum, ops/qc_decode.
    vn_update_qc)."""
    fresh_ref = refs[0] if with_fresh else None
    out_ref = refs[1 + with_fresh]
    bits_ref = refs[2 + with_fresh] if emit_bits else None
    col = col0 + pl.program_id(0)
    z0, lanes = _tile_origin(T, LB)
    z = z0 + jax.lax.broadcasted_iota(jnp.int32, (T,), 0)
    aligned = pl.ds(z0, T)

    def group(node_start, d, block_start):
        base = block_start + (col - node_start) * d
        r = []
        for k in range(d):
            rows = _rotated_rows(z, shift_ref[base + k], Z, False)
            r.append(_load(r_ref, (src_ref[base + k], rows, lanes), qscale))
        lv = llr_ref[col, aligned, lanes].astype(jnp.float32)
        rsum = r[0]
        for x in r[1:]:
            rsum = rsum + x
        total = lv + rsum
        fr = None
        if with_fresh:
            fr = (fresh_ref[lanes] != 0)[None, :]
        if emit_bits:
            tb = jnp.where(fr, lv, total) if with_fresh else total
            bits_ref[col, aligned, lanes] = (~jnp.signbit(tb)).astype(
                jnp.int8)
        for k in range(d):
            if d == 1:
                pre = lv  # sole edge: leave-one-out is the channel LLR
            else:
                pre = total - r[k]
                if with_fresh:
                    pre = jnp.where(fr, lv, pre)
            if alg == "min-sum":
                out = jnp.clip(pre, -clamp, clamp)
            else:
                out = jnp.copysign(phi_abs(jnp.abs(pre), phi_pre), pre)
            _store(out_ref, (base + k, aligned, lanes), out, qscale)

    for node_start, count, d, block_start in groups:
        if node_start + count <= col0:
            continue
        pl.when((col >= node_start) & (col < node_start + count))(
            partial(group, node_start, d, block_start))


def _params():
    return plgpu.CompilerParams(num_warps=_NUM_WARPS)


def cn_pass(msgs_v, syn3, tables: QCDecodeTables, alg: str = "sum-product",
            beta: float = 0.0, phi_pre: float = PRE_THRESHOLD, alpha=1.0,
            qscale: float = 4.0, interpret: bool = False):
    """msgs_v [nb, Z, B] (variable order), syn3 [R, Z, B] int8 ->
    r_c [nb, Z, B] (check order)."""
    Z, B = tables.Z, msgs_v.shape[-1]
    d_max = max(g.degree for g in tables.row_groups)
    T, LB = tile_config(d_max, Z, B)
    n_rows = sum(g.count for g in tables.row_groups)
    kernel = partial(
        _cn_kernel, groups=_groups_with_nodes(tables.row_groups), Z=Z, T=T,
        LB=LB, alg=alg, beta=beta, alpha=alpha, phi_pre=phi_pre,
        qscale=qscale)
    return pl.pallas_call(
        kernel,
        grid=(n_rows, Z // T, B // LB),
        out_shape=jax.ShapeDtypeStruct(msgs_v.shape, msgs_v.dtype),
        backend="triton",
        compiler_params=_params(),
        interpret=interpret,
        name="ldpc_cn_pass",
    )(tables.vn_of_cn, tables.cn_shift, msgs_v, syn3)


def vn_pass(r_c, llr3, msgs_prev, tables: QCDecodeTables, emit_bits: bool,
            alg: str = "sum-product", clamp: float = 64.0,
            phi_pre: float = PRE_THRESHOLD, fresh=None,
            include_d1: bool = False, qscale: float = 4.0,
            interpret: bool = False):
    """r_c [nb, Z, B] (check order) -> msgs_v [nb, Z, B] (variable order),
    written into the donated ``msgs_prev``; plus hard decisions
    [C, Z, B] int8 when ``emit_bits``.

    Degree-1 columns run only when ``emit_bits`` or ``include_d1`` (the
    first iteration after a refill, whose new LLRs change φ(llr))."""
    Z, B = tables.Z, r_c.shape[-1]
    d_max = max(g.degree for g in tables.col_groups)
    T, LB = tile_config(d_max, Z, B)
    groups = _groups_with_nodes(tables.col_groups)
    n_cols = sum(g.count for g in tables.col_groups)
    col0 = 0
    if not (emit_bits or include_d1):
        col0 = sum(count for _, count, d, _ in groups if d == 1)
    with_fresh = fresh is not None
    operands = [tables.cn_of_vn, tables.vn_shift, r_c, llr3]
    if with_fresh:
        operands.append(fresh)
    operands.append(msgs_prev)
    out_shape = [jax.ShapeDtypeStruct(msgs_prev.shape, msgs_prev.dtype)]
    if emit_bits:
        out_shape.append(jax.ShapeDtypeStruct((n_cols, Z, B), jnp.int8))
    kernel = partial(
        _vn_kernel, groups=groups, col0=col0, Z=Z, T=T, LB=LB, alg=alg,
        clamp=clamp, phi_pre=phi_pre, qscale=qscale, emit_bits=emit_bits,
        with_fresh=with_fresh)
    out = pl.pallas_call(
        kernel,
        grid=(n_cols - col0, Z // T, B // LB),
        out_shape=out_shape,
        input_output_aliases={len(operands) - 1: 0},
        backend="triton",
        compiler_params=_params(),
        interpret=interpret,
        name="ldpc_vn_pass",
    )(*operands)
    return (out[0], out[1]) if emit_bits else (out[0], None)


def _col_of_vblock(tables: QCDecodeTables) -> np.ndarray:
    """Sorted column of every variable-order block."""
    return np.concatenate([
        np.repeat(np.arange(c0, c0 + count), d)
        for c0, count, d, _ in _groups_with_nodes(tables.col_groups)])


def init_messages_qc_triton(llr2d, tables: QCDecodeTables,
                            dtype=jnp.float32, alg: str = "sum-product",
                            phi_pre: float = PRE_THRESHOLD,
                            clamp: float = 64.0, qscale: float = 4.0):
    """[E, B] fresh variable-order messages: every slot of a column gets
    φ(llr) (min-sum: the llr itself). Degree-1 columns get exactly what the
    VN pass writes for them (their launches are skipped on non-emit
    iterations), and int8 quantizes every column the same way."""
    B = llr2d.shape[-1]
    llr = llr2d.reshape(-1, tables.Z, B).astype(jnp.float32)
    if alg == "min-sum":
        clipped = jnp.clip(llr, -clamp, clamp)
        if dtype == jnp.int8:
            p = quantize_msgs(clipped, qscale)
        else:
            d1 = np.zeros(llr.shape[0], bool)
            for c0, count, d, _ in _groups_with_nodes(tables.col_groups):
                d1[c0:c0 + count] = d == 1
            p = jnp.where(d1[:, None, None], clipped, llr)
    else:
        p = jnp.copysign(phi_abs(jnp.abs(llr), phi_pre), llr)
    m = jnp.take(p.astype(dtype), _col_of_vblock(tables), axis=0)
    return m.reshape(tables.n_edges, B)


def _views(msgs2d, llr2d, syn2d, tables: QCDecodeTables):
    B = msgs2d.shape[-1]
    Z = tables.Z
    # channel LLRs are read in the message dtype; 1-byte messages keep
    # bf16 LLRs (channel values need more mantissa than messages)
    ldt = (jnp.bfloat16 if jnp.dtype(msgs2d.dtype).itemsize == 1
           else msgs2d.dtype)
    return (msgs2d.reshape(tables.n_blocks, Z, B),
            llr2d.reshape(-1, Z, B).astype(ldt),
            syn2d.reshape(-1, Z, B))


def _passes(llr, syn, tables, alg, beta, clamp, phi_pre, alpha, qscale,
            interpret):
    """The check pass, the variable pass and one plain iteration (no emit)
    with the decode's settings bound."""
    cn = partial(cn_pass, syn3=syn, tables=tables, alg=alg, beta=beta,
                 phi_pre=phi_pre, alpha=alpha, qscale=qscale,
                 interpret=interpret)
    vn = partial(vn_pass, llr3=llr, tables=tables, alg=alg, clamp=clamp,
                 phi_pre=phi_pre, qscale=qscale, interpret=interpret)

    def iteration(_, m):
        return vn(cn(m), msgs_prev=m, emit_bits=False)[0]

    return cn, vn, iteration


_STATIC = ("alg", "beta", "clamp", "phi_pre", "alpha", "qscale", "interpret")


@partial(jax.jit, static_argnames=("k",) + _STATIC)
def run_iterations_qc_triton(msgs2d, llr2d, syn2d, tables: QCDecodeTables,
                             k: int, alg: str = "sum-product",
                             beta: float = 0.0, clamp: float = 64.0,
                             phi_pre: float = PRE_THRESHOLD, fresh=None,
                             alpha=1.0, qscale: float = 4.0,
                             interpret: bool = False):
    """2-D-interface twin of ops.qc_decode.run_iterations_qc (messages in
    variable order): k-1 light iterations, then one that also emits int8
    hard decisions, then the XLA parity check.

    ``fresh`` ([B] bool/int8 or None): lanes refilled since the last
    superstep; the first iteration's VN pass emits their init messages."""
    msgs, llr, syn = _views(msgs2d, llr2d, syn2d, tables)
    B = msgs.shape[-1]
    cn, vn, body = _passes(llr, syn, tables, alg, beta, clamp, phi_pre,
                           alpha, qscale, interpret)
    fr = None if fresh is None else (fresh.reshape(-1) != 0).astype(jnp.int8)
    lo = 0
    if fr is not None and k > 1:
        msgs, _ = vn(cn(msgs), msgs_prev=msgs, emit_bits=False, fresh=fr,
                     include_d1=True)
        lo = 1
    msgs = jax.lax.fori_loop(lo, k - 1, body, msgs)
    msgs, bits = vn(cn(msgs), msgs_prev=msgs, emit_bits=True,
                    fresh=fr if k == 1 else None)
    violated = parity_violations_qc(bits, syn, tables)
    return (msgs.reshape(tables.n_edges, B),
            bits.reshape(tables.n_vars, B), violated)


@partial(jax.jit, static_argnames=("b",) + _STATIC)
def burst_iterations_qc_triton(msgs2d, llr2d, syn2d, tables: QCDecodeTables,
                               b: int, alg: str = "sum-product",
                               beta: float = 0.0, clamp: float = 64.0,
                               phi_pre: float = PRE_THRESHOLD, alpha=1.0,
                               qscale: float = 4.0, interpret: bool = False):
    """``b`` plain iterations with no emit and no parity: a bit-identical
    prefix of run_iterations_qc_triton (degree-1 messages are constant,
    so skipping their launches does not depend on the emit schedule)."""
    msgs, llr, syn = _views(msgs2d, llr2d, syn2d, tables)
    B = msgs.shape[-1]
    *_, body = _passes(llr, syn, tables, alg, beta, clamp, phi_pre, alpha,
                       qscale, interpret)
    msgs = jax.lax.fori_loop(0, b, body, msgs)
    return msgs.reshape(tables.n_edges, B)
