"""Decoder orchestration: batched decode with on-the-fly frame replacement.

A redesign of the reference's host orchestration
(ldpc_decoder_gpu.cu:283-634 / ldpc_decoder_gpu.cpp:374-788). The reference
polls a parity-flag byte array every k iterations, then runs a host-computed
permute/retire/refill schedule (flood_permute_vecs + flood_refill). Here the
whole schedule is a *fixed-shape masked update on device*:

- a pool of all frames for the run lives in device memory (sorted
  layouts);
- B = parallel_factor lanes decode in parallel;
- every k iterations a jitted superstep checks parity, retires finished or
  over-budget lanes (packing their hard decisions into the results array),
  and refills those lanes from the pool — no slot compaction, no host data;
- because the pool is device-resident, the decoder goes one step further
  than the reference *can*: the whole decode — superstep, retire, refill,
  termination test — runs inside a single ``lax.while_loop`` dispatch with
  **zero** host round-trips (the reference must read a flag array every k
  iterations, ldpc_decoder_gpu.cu:374, and each read waits for the
  device to drain).

A host-polling mode (one scalar per superstep) remains available for
progress logging. Everything is shape-static, so one XLA compilation serves
the whole decode regardless of which frames finish when.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_decoder_tpu.channels.base import Channel
from ldpc_decoder_tpu.codes.code import LDPCCode
from ldpc_decoder_tpu.codes.compiled import CompiledCode, compile_code
from ldpc_decoder_tpu.ops import decode as ops
from ldpc_decoder_tpu.ops.phi import PRE_THRESHOLD, pre_from_infinity_threshold
from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams


class DecodeState(NamedTuple):
    """Device-resident decode state (a pytree). Frames on the lane axis."""

    msgs: jnp.ndarray        # [E, B] φ-domain messages, cn-edge order
    llr: jnp.ndarray         # [n_vars, B] channel LLRs, sorted vn order
    syn: jnp.ndarray         # [n_checks, B] int8, sorted cn order
    frame_ids: jnp.ndarray   # [B] int32 pool index of each lane
    iters_done: jnp.ndarray  # [B] int32 iterations run on current frame
    active: jnp.ndarray      # [B] bool
    pool_next: jnp.ndarray   # [] int32 next pool frame to load
    supersteps: jnp.ndarray  # [] int32 supersteps executed
    results: jnp.ndarray     # [N+1, n_words] uint32 packed decoded bits
    iters_out: jnp.ndarray   # [N+1] int32 iterations used per frame
    fresh: jnp.ndarray       # [B] int8: lane refilled since last superstep
    #                          (its msgs are stale — reset in-kernel on the
    #                          next superstep's first iteration)


@dataclass
class DecodeStats:
    """Per-decode iteration statistics (feeds the test report;
    ldpc_decoder_gpu.cu:616-628)."""

    iterations: np.ndarray  # [N] per-frame iteration counts
    total_supersteps: int
    total_iterations: int  # global BP iterations executed
    elapsed_seconds: float
    batch_size: int

    @property
    def min_iter(self) -> int:
        return int(self.iterations.min())

    @property
    def max_iter(self) -> int:
        return int(self.iterations.max())

    @property
    def avg_iter(self) -> float:
        return float(self.iterations.mean())

    @property
    def iter_time_per_vector(self) -> float:
        # reference formula (ldpc_decoder_gpu.cu:628):
        # elapsed / (global iterations * batch)
        denom = self.total_iterations * self.batch_size
        return self.elapsed_seconds / denom if denom else 0.0


def _pack_bits_natural(bits_sorted: jnp.ndarray, vn_pos: jnp.ndarray,
                       n_words: int,
                       block_perm: tuple[int, ...] | None = None,
                       Z: int = 0) -> jnp.ndarray:
    """[n_vars, B] sorted int8 -> [B, n_words] uint32 packed natural order
    (the deinterlace_output analog, flood.cu:277-295).

    When the sorted order is a QC block permutation (``block_perm``/``Z``
    given), the n_vars-row gather collapses to a C-block static permute."""
    if block_perm is not None:
        b = bits_sorted.shape[-1]
        blocks = bits_sorted.reshape(len(block_perm), Z, b)
        bits_nat = blocks[np.array(block_perm)].reshape(-1, b)
    else:
        bits_nat = jnp.take(bits_sorted, vn_pos, axis=0)
    n_vars, b = bits_nat.shape
    pad = n_words * 32 - n_vars
    if pad:
        bits_nat = jnp.concatenate(
            [bits_nat, jnp.zeros((pad, b), bits_nat.dtype)], axis=0
        )
    # pack via two exact contractions instead of a 32-step u32 shift/sum
    # chain: 16 distinct powers of two with 0/1 weights sum below 2^16,
    # exact in f32 accumulation (bf16 operands are exact powers of two /
    # bits)
    blocks = bits_nat.reshape(n_words, 32, b).astype(jnp.bfloat16)
    w16 = (2.0 ** np.arange(16)).astype(jnp.bfloat16)
    lo = jnp.einsum("wzb,z->wb", blocks[:, :16], w16,
                    preferred_element_type=jnp.float32)
    hi = jnp.einsum("wzb,z->wb", blocks[:, 16:], w16,
                    preferred_element_type=jnp.float32)
    words = lo.astype(jnp.uint32) | (hi.astype(jnp.uint32) << 16)
    return words.T  # [B, n_words]


def choose_kernel(params: StaticParams, is_qc: bool, platform: str) -> str:
    """The node-update implementation for a code on a backend: "triton"
    (the fused Pallas kernels of ops/qc_triton.py) or "xla" (the plain
    paths, ops/qc_decode.py and ops/decode.py).

    "auto" takes the kernels for a QC code on a GPU when they take the
    message dtype, and XLA everywhere else. An explicit "pallas" request
    that cannot be honoured raises: the kernels exist for QC codes only,
    compile only for the GPU (``pallas_interpret`` runs them through the
    Pallas interpreter instead, for tests), and do not take float8_e5m2.
    """
    from ldpc_decoder_tpu.ops.qc_triton import DTYPES

    impl = params.kernel_impl
    if impl == "xla":
        return "xla"
    if impl == "auto":
        ok = is_qc and platform == "gpu" and params.message_dtype in DTYPES
        return "triton" if ok else "xla"
    if impl != "pallas":
        raise ValueError(
            f"kernel_impl must be 'auto', 'pallas' or 'xla', got {impl!r}")
    if not is_qc:
        raise ValueError("kernel_impl='pallas' needs a quasi-cyclic code; "
                         "any other alist decodes on the XLA path")
    if params.message_dtype not in DTYPES:
        raise ValueError(
            f"the Pallas kernels take message dtypes {DTYPES}, not "
            f"{params.message_dtype!r}; use kernel_impl='xla' or 'auto'")
    if platform != "gpu" and not params.pallas_interpret:
        raise ValueError(
            f"the Pallas Triton kernels compile only for a GPU, not for "
            f"{platform!r}; use kernel_impl='xla' or 'auto'")
    return "triton"


class LDPCDecoder:
    """Batched syndrome BP decoder for one code + channel on one device.

    Public surface mirrors the reference decoder class
    (h/ldpc_decoder_gpu_cuda.h:108-132): ``parallel_factor()`` and
    ``decode(dyn_params, n_vecs, values, syndromes)``.
    """

    def __init__(
        self,
        code: LDPCCode | CompiledCode,
        channel: Channel,
        static_params: StaticParams | None = None,
        device=None,
        qc=None,  # QCStructure: enables the rotation-based fast path
    ):
        self.cc = code if isinstance(code, CompiledCode) else compile_code(code)
        self.code = self.cc.code
        self.channel = channel
        self.params = static_params or StaticParams()
        self.device = device
        perm_v = perm_c = None
        if qc is None and self.params.qc_autodetect:
            # undeclared QC structure (plain alist from a production
            # standard) upgrades to the fused rotation kernels
            from ldpc_decoder_tpu.codes.qc import (
                detect_qc_structure,
                detect_qc_structure_permuted,
            )

            qc = detect_qc_structure(self.code)
            if qc is not None:
                import logging

                logging.getLogger(__name__).info(
                    "detected QC structure Z=%d (%dx%d base) — using the "
                    "fused rotation kernels", qc.Z, qc.n_base_rows,
                    qc.n_base_cols)
            elif self.code.n_erased_vars == 0:
                # block-interleaved numberings of a QC code (common tool
                # output) are renumbered on the fly: the permutations are
                # composed into the sorted-order I/O tables below, so the
                # user's natural-layout arrays decode unchanged. (Erased
                # tails are numbering-dependent — those codes keep the
                # declared structure path.)
                res = detect_qc_structure_permuted(self.code)
                if res is not None:
                    qc, perm_v, perm_c = res
                    import logging

                    logging.getLogger(__name__).info(
                        "detected block-interleaved QC structure Z=%d "
                        "(%dx%d base) — renumbering via the I/O order "
                        "tables", qc.Z, qc.n_base_rows, qc.n_base_cols)
        self.qc = qc
        platform = (device or jax.local_devices()[0]).platform
        self.kernel = choose_kernel(self.params, qc is not None, platform)
        if qc is not None:
            from ldpc_decoder_tpu.ops import qc_decode as qc_ops

            qct = qc_ops.QCDecodeTables.from_structure(
                qc, self.code.n_erased_vars
            )
            if (
                qct.n_vars != self.code.n_vars
                or qct.n_checks != self.code.n_checks
                or qct.n_edges != self.code.n_edges
            ):
                raise ValueError("QC structure does not match the code")
            if perm_v is not None:
                # compose the interleaved->aligned renumbering into the
                # natural<->sorted order tables: "natural" stays the
                # USER's numbering everywhere downstream (decode() I/O,
                # result packing, on-device datagen), while the kernels
                # see the aligned sorted space
                import dataclasses as _dc

                inv_v = np.empty_like(perm_v)
                inv_v[perm_v] = np.arange(perm_v.size, dtype=perm_v.dtype)
                inv_c = np.empty_like(perm_c)
                inv_c[perm_c] = np.arange(perm_c.size, dtype=perm_c.dtype)
                qct = _dc.replace(
                    qct,
                    vn_order=jnp.asarray(
                        inv_v[np.asarray(qct.vn_order)]),
                    vn_pos=jnp.asarray(np.asarray(qct.vn_pos)[perm_v]),
                    cn_order=jnp.asarray(
                        inv_c[np.asarray(qct.cn_order)]),
                )
            self.tables = qct
            if self.kernel == "triton":
                from ldpc_decoder_tpu.ops import qc_triton

                self._run_iterations = self._bind_alg(
                    qc_triton.run_iterations_qc_triton)
                self._run_burst = self._bind_alg(
                    qc_triton.burst_iterations_qc_triton)
                init = qc_triton.init_messages_qc_triton
            else:
                self._run_iterations = self._bind_alg(
                    qc_ops.run_iterations_qc)
                self._run_burst = self._bind_alg(qc_ops.burst_iterations_qc)
                init = qc_ops.init_messages_qc
        else:
            self.tables = ops.DecodeTables.from_compiled(self.cc)
            self._run_iterations = self._bind_alg(ops.run_iterations)
            self._run_burst = self._bind_alg(ops.burst_iterations)
            init = ops.init_messages
        self._init_messages = partial(
            init, alg=self.params.algorithm, clamp=self.params.minsum_clamp,
            qscale=self.params.minsum_qscale,
        ) if self.params.algorithm != "sum-product" else init
        self.msg_dtype = {
            "bfloat16": jnp.bfloat16,
            "float8_e5m2": jnp.float8_e5m2,
            "int8": jnp.int8,
        }.get(self.params.message_dtype, jnp.float32)
        # LLR-state storage dtype (see _init_state)
        self._llr_dtype = (jnp.bfloat16
                           if jnp.dtype(self.msg_dtype).itemsize == 1
                           else self.msg_dtype)
        self.n_words = (self.code.n_vars + 31) // 32
        self._parallel_factor = self._choose_parallel_factor()
        self._superstep_cache: dict[tuple[int, int, int], callable] = {}
        # natural<->sorted I/O orders: the tables' copies, NOT cc's —
        # identical for every declared/aligned code, but for an
        # interleaved-QC alist the detected renumbering is composed into
        # the tables only (cc stays in the user's numbering for the
        # generic-path index arrays)
        self._vn_order_io = np.asarray(self.tables.vn_order)[
            : self.code.n_vars]
        self._cn_order_io = np.asarray(self.tables.cn_order)[
            : self.code.n_checks]

    def _bind_alg(self, run_fn):
        """Bind the check-node rule (StaticParams.algorithm) and, for the
        Pallas kernels under test, interpret mode into the iteration
        runner; the default sum-product runner stays the bare function so
        jit caches are shared."""
        kw = {}
        if self.params.algorithm != "sum-product":
            kw = dict(
                alg=self.params.algorithm,
                beta=self.params.minsum_offset,
                clamp=self.params.minsum_clamp,
                alpha=self.params.minsum_alpha,
                qscale=self.params.minsum_qscale,
            )
        if self.kernel == "triton" and self.params.pallas_interpret:
            kw["interpret"] = True
        return partial(run_fn, **kw) if kw else run_fn

    # ------------------------------------------------------------------
    def _device_memory(self) -> int:
        """Bytes the decoder may plan for: StaticParams.device_memory_bytes,
        else the device's reported ``bytes_limit``; a CPU device plans
        against the host's physical memory. An accelerator that reports no
        limit is an error, not a guess."""
        if self.params.device_memory_bytes is not None:
            return self.params.device_memory_bytes
        dev = self.device or jax.local_devices()[0]
        stats = dev.memory_stats() or {}
        if "bytes_limit" in stats:
            return int(stats["bytes_limit"])
        if dev.platform == "cpu":
            import os

            return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        raise RuntimeError(
            f"{dev} reports no bytes_limit; set "
            f"StaticParams.device_memory_bytes")

    def _choose_parallel_factor(self) -> int:
        """Largest power-of-two lane count fitting device memory, capped by
        the user's -p (reference memory model, ldpc_decoder_gpu.cu:72-99).
        StaticParams.parallel_factor_user bypasses the model entirely.

        Per-lane bytes are counted from the buffers each path keeps live
        across one superstep; pool frames (loading_factor per lane) add raw
        values, syndromes and packed results.
        """
        if self.params.parallel_factor_user is not None:
            return int(self.params.parallel_factor_user)
        msg_bytes = jnp.dtype(self.msg_dtype).itemsize
        llr_bytes = jnp.dtype(self._llr_dtype).itemsize
        e, nv, nc = self.code.n_edges, self.code.n_vars, self.code.n_checks
        if self.kernel == "triton":
            # msgs_v (the VN pass writes it in place) + r_c + one copy XLA
            # may keep across the loop carry, in the message dtype; llr
            # state, int8 syndrome and hard decisions; the XLA parity
            # check's gathered and rotated int8 bits (2 edge arrays) and
            # its int32 per-check sums
            per_lane = (3 * e * msg_bytes + 2 * e + nv * (llr_bytes + 1)
                        + 5 * nc)
        else:
            # XLA paths: the resident messages and one rotated/gathered
            # copy, plus up to 3 edge-sized fp32 temporaries between
            # fusions (r_c, r_v, new messages) and fp32 totals
            per_lane = e * msg_bytes * 2 + 3 * e * 4 + 3 * nv * 4 + nc
        # pool: raw values fp32 + syndrome + packed results, x loading factor
        per_pool_frame = nv * 4 + nc + (nv // 8)
        table_bytes = 3 * e * 4 + 2 * nv * 4 + 2 * nc * 4
        mem = self._device_memory()
        budget = mem * (1.0 - self.params.memory_headroom) - table_bytes
        # assume default loading factor 4 for sizing
        denom = per_lane + 4 * per_pool_frame
        max_lanes = max(1, int(budget // denom))
        log_pf = min(
            int(math.floor(math.log2(max_lanes))),
            self.params.max_log_parallel_factor_user,
        )
        return 1 << max(log_pf, 0)

    def parallel_factor(self) -> int:
        return self._parallel_factor

    def set_erased_variables(self, n_erased_inputs: int) -> None:
        """Mark the trailing ``n`` variables as erased/punctured (the
        reference's setter, h/ldpc_decoder_gpu.h:122-125): their channel
        LLRs are zeroed at refill. Clears the compiled-superstep cache."""
        import dataclasses

        import numpy as np_

        erased_nat = np_.zeros(self.code.n_vars, dtype=bool)
        if n_erased_inputs:
            erased_nat[self.code.n_vars - n_erased_inputs:] = True
        mask = jnp.asarray(
            erased_nat[np_.asarray(self.tables.vn_order)])[:, None]
        self.tables = dataclasses.replace(
            self.tables, erased_mask_sorted=mask)
        self.code = dataclasses.replace(
            self.code, n_erased_vars=int(n_erased_inputs))
        self._superstep_cache.clear()

    def decoding_input_is_llr(self) -> bool:
        """Channel values are converted on device for all built-in channels
        (the llr_bsc/llr_biawgn analog), so raw channel values are expected
        (h/ldpc_decoder_gpu_cuda.h:118-122)."""
        return False

    # ------------------------------------------------------------------
    def _build_superstep(self, k: int, max_iter: int, n_pool: int,
                         phi_pre: float = PRE_THRESHOLD,
                         input_is_llr: bool = False):
        """The superstep core: k iterations + parity + retire + refill.
        Pure (state, pools) -> state; jitted by the two driver modes.

        ``phi_pre`` realizes DynamicParams.infinity_threshold (the φ-input
        floor, ops/phi.py); ``input_is_llr`` skips the device LLR
        conversion for externally supplied LLR pools (the reference's
        decoding_input_is_llr contract, h/ldpc_decoder_gpu_cuda.h:118-122).
        """
        tables = self.tables
        n_words = self.n_words
        msg_dtype = self.msg_dtype

        # QC block orders make the natural-order gather a static C-block
        # permute (vn_pos maps whole Z-blocks)
        block_perm, blk_Z = None, 0
        Z = getattr(tables, "Z", 0)
        if Z and self.code.n_vars % Z == 0:
            vp = np.asarray(tables.vn_pos)
            cand = vp[::Z] // Z
            if (vp.reshape(-1, Z) == (cand[:, None] * Z
                                      + np.arange(Z)[None, :])).all():
                block_perm, blk_Z = tuple(int(x) for x in cand), Z

        def load_lanes(pool_values, pool_syn, ids, fresh, state_llr,
                       state_syn):
            """Masked lane refill from the pool (flood_refill analog)."""
            safe = jnp.clip(ids, 0, n_pool - 1)
            vals = jnp.take(pool_values, safe, axis=1)  # [n_vars, B]
            llr_new = (vals if input_is_llr
                       else self.channel.llr_from_channel(vals))
            llr_new = jnp.where(tables.erased_mask_sorted, 0.0, llr_new)
            llr_new = llr_new.astype(state_llr.dtype)
            syn_new = jnp.take(pool_syn, safe, axis=1)
            lane = fresh[None, :]
            return (
                jnp.where(lane, llr_new, state_llr),
                jnp.where(lane, syn_new, state_syn),
            )

        import inspect

        try:
            supports_fresh = "fresh" in inspect.signature(
                self._run_iterations).parameters
        except (TypeError, ValueError):
            supports_fresh = False

        def superstep(state: DecodeState, pool_values, pool_syn):
            # fresh is passed unconditionally: every superstep takes the
            # peeled-first-iteration path (and the kernels' degree-1
            # launches) even when no lane was refilled. Gating it behind
            # lax.cond(any(fresh)) would make the cond copy the donated
            # edge-sized message buffers.
            extra = {"fresh": state.fresh} if supports_fresh else {}
            msgs, bits, violated = self._run_iterations(
                state.msgs, state.llr, state.syn, tables, k,
                phi_pre=phi_pre, **extra,
            )
            iters_done = state.iters_done + k
            done = state.active & (~violated | (iters_done >= max_iter))

            # retire: pack + scatter results/iteration counts, gated
            # on-device so supersteps where nothing finished (the common
            # case before the waterfall) skip the pack entirely.
            def _retire(op):
                results0, iters_out0 = op
                packed = _pack_bits_natural(bits, tables.vn_pos, n_words,
                                            block_perm, blk_Z)
                rows = jnp.where(done, state.frame_ids, n_pool)
                return (results0.at[rows].set(packed),
                        iters_out0.at[rows].set(iters_done))

            results, iters_out = jax.lax.cond(
                jnp.any(done), _retire, lambda op: op,
                (state.results, state.iters_out),
            )

            # refill from pool
            order = jnp.cumsum(done.astype(jnp.int32)) - done.astype(jnp.int32)
            new_ids = state.pool_next + order
            has_new = done & (new_ids < n_pool)
            frame_ids = jnp.where(has_new, new_ids, state.frame_ids)
            active = jnp.where(done, has_new, state.active)
            pool_next = state.pool_next + jnp.sum(done.astype(jnp.int32))
            pool_next = jnp.minimum(pool_next, n_pool)

            # gate the refill on-device so supersteps where no lane
            # finished skip the work entirely (the reference's host
            # scheduler does the analogous skip by branching on num_new,
            # ldpc_decoder_gpu.cu:464)
            if supports_fresh:
                # lane-reset refill: only the node-sized llr/syn state is
                # touched; the edge-sized message arrays keep the retired
                # frame's data and the NEXT superstep's first VN pass
                # emits init values for the flagged lanes in-kernel
                # (run_iterations_*'s ``fresh``) — saves ~4 edge-array
                # passes (init + masked merge) per refill. Cost: the
                # flagged lane's first iteration reads stale messages and
                # is a wash (its k iterations deliver k-1 real ones).
                def _refill(op):
                    llr0, syn0 = op
                    return load_lanes(pool_values, pool_syn, frame_ids,
                                      has_new, llr0, syn0)

                llr, syn = jax.lax.cond(
                    jnp.any(has_new), _refill, lambda op: op,
                    (state.llr, state.syn),
                )
                fresh_next = has_new.astype(jnp.int8)
            else:
                def _refill(op):
                    llr0, syn0, msgs0 = op
                    llr, syn = load_lanes(
                        pool_values, pool_syn, frame_ids, has_new, llr0,
                        syn0
                    )
                    fresh = self._init_messages(llr, tables,
                                                dtype=msg_dtype,
                                                phi_pre=phi_pre)
                    merged = jnp.where(has_new[None, :], fresh, msgs0)
                    return llr, syn, merged

                llr, syn, msgs = jax.lax.cond(
                    jnp.any(has_new), _refill, lambda op: op,
                    (state.llr, state.syn, msgs),
                )
                fresh_next = jnp.zeros_like(state.fresh)
            iters_done = jnp.where(done, 0, iters_done)

            return DecodeState(
                msgs=msgs, llr=llr, syn=syn, frame_ids=frame_ids,
                iters_done=iters_done, active=active, pool_next=pool_next,
                supersteps=state.supersteps + 1,
                results=results, iters_out=iters_out, fresh=fresh_next,
            )

        return superstep

    @staticmethod
    def _n_remaining(state: DecodeState, n_pool: int) -> jnp.ndarray:
        return jnp.sum(state.active.astype(jnp.int32)) + (
            n_pool - state.pool_next
        )

    def _superstep_fn(self, k: int, max_iter: int, n_pool: int,
                      phi_pre: float = PRE_THRESHOLD,
                      input_is_llr: bool = False):
        """Host-polling driver: one jitted superstep returning the
        remaining-frames scalar (for progress logging)."""
        key = ("poll", k, max_iter, n_pool, phi_pre, input_is_llr)
        if key in self._superstep_cache:
            return self._superstep_cache[key]
        core = self._build_superstep(k, max_iter, n_pool, phi_pre,
                                     input_is_llr)

        def step(state, pool_values, pool_syn):
            new_state = core(state, pool_values, pool_syn)
            return new_state, self._n_remaining(new_state, n_pool)

        fn = jax.jit(step, donate_argnums=(0,))
        self._superstep_cache[key] = fn
        return fn

    def _full_decode_fn(self, k: int, max_iter: int, n_pool: int,
                        phi_pre: float = PRE_THRESHOLD,
                        input_is_llr: bool = False, burst: int = 0):
        """Fused driver: state init + the whole decode as one on-device
        while_loop in a SINGLE dispatch — zero host round-trips until the
        results come back (the init was previously dispatched eagerly:
        ~30 ops incl. an edge-sized message build inside the timed
        region).

        ``burst``: plain BP iterations run before the first superstep
        (DynamicParams.num_iter_first_check semantics — skips the emit/
        parity/retire machinery while no frame can have converged)."""
        key = ("fused", k, max_iter, n_pool, phi_pre, input_is_llr, burst)
        if key in self._superstep_cache:
            return self._superstep_cache[key]
        core = self._build_superstep(k, max_iter, n_pool, phi_pre,
                                     input_is_llr)

        def run(pool_values, pool_syn):
            state = self._init_state(pool_values, pool_syn, n_pool,
                                     phi_pre, input_is_llr)
            if burst > 0:
                msgs = self._run_burst(state.msgs, state.llr, state.syn,
                                       self.tables, burst, phi_pre=phi_pre)
                state = state._replace(
                    msgs=msgs, iters_done=state.iters_done + burst)
            return jax.lax.while_loop(
                lambda s: self._n_remaining(s, n_pool) > 0,
                lambda s: core(s, pool_values, pool_syn),
                state,
            )

        fn = jax.jit(run)
        self._superstep_cache[key] = fn
        return fn

    def _mesh_decode_fn(self, k: int, max_iter: int, n_pool_local: int,
                        mesh, phi_pre: float = PRE_THRESHOLD,
                        burst: int = 0):
        """Multi-chip driver: the whole decode shard_mapped over the 'batch'
        mesh axis. Each device runs an independent local decoder over its
        slice of the frame pool (frames never span devices — SURVEY.md §2);
        the only cross-chip traffic is the psum'd remaining-frames scalar
        in the loop condition."""
        key = ("mesh", k, max_iter, n_pool_local, id(mesh), phi_pre, burst)
        if key in self._superstep_cache:
            return self._superstep_cache[key]
        from jax.sharding import PartitionSpec as P

        core = self._build_superstep(k, max_iter, n_pool_local, phi_pre)

        def local_run(pool_values, pool_syn):
            state = self._init_state(pool_values, pool_syn, n_pool_local,
                                     phi_pre)
            # make every state leaf device-varying so the while_loop carry
            # has a consistent variance signature (counters/zeroed results
            # start as device-invariant constants and become varying in
            # the body when updated from pool-derived data)
            def _to_varying(x):
                if "batch" in getattr(jax.typeof(x), "vma", frozenset()):
                    return x  # already device-varying (pool-derived)
                return jax.lax.pcast(x, "batch", to="varying")

            state = jax.tree.map(_to_varying, state)
            if burst > 0:
                msgs = self._run_burst(state.msgs, state.llr, state.syn,
                                       self.tables, burst, phi_pre=phi_pre)
                state = state._replace(
                    msgs=msgs, iters_done=state.iters_done + burst)

            def cond(s):
                return (
                    jax.lax.psum(self._n_remaining(s, n_pool_local), "batch")
                    > 0
                )

            final = jax.lax.while_loop(
                cond, lambda s: core(s, pool_values, pool_syn), state
            )
            return (
                final.results,
                final.iters_out,
                final.supersteps[None],  # [1] per device
            )

        fn = jax.jit(
            jax.shard_map(
                local_run,
                mesh=mesh,
                in_specs=(P(None, "batch"), P(None, "batch")),
                out_specs=(P("batch", None), P("batch"), P("batch")),
                # check_vma=False is REQUIRED, not a shortcut: with the
                # check on, JAX 0.9 demands a `vma` annotation on every
                # pallas_call out_shape reached from the body, so the
                # kernels of ops/qc_triton.py would need the mesh context
                # threaded through.
                # Safety argument for skipping it here: (a) the body is
                # purely per-device — its ONLY collective is the psum'd
                # remaining-frames scalar in `cond`, whose operand is
                # device-varying by construction (pool-derived); (b) all
                # initially-invariant carry leaves are promoted to
                # varying above (pcast), so no leaf is ever consumed
                # under a wrong invariance assumption; (c) every output
                # is declared device-varying in out_specs, claiming no
                # invariance downstream.
                check_vma=False,
            )
        )
        self._superstep_cache[key] = fn
        return fn

    def decode_sharded(
        self,
        dyn_params: DynamicParams,
        n_vecs: int,
        values: np.ndarray,
        syndromes: np.ndarray,
        mesh,
    ) -> tuple[np.ndarray, DecodeStats]:
        """Decode with the frame pool sharded over ``mesh``'s 'batch' axis.

        Frames are dealt round-robin to devices; each device refills its
        lanes only from its local pool shard. Total lanes in flight =
        parallel_factor() * n_devices.
        """
        import time

        n_dev = int(np.prod(mesh.devices.shape))
        n_local = -(-n_vecs // n_dev)  # ceil
        n_pad = n_local * n_dev
        k = dyn_params.num_iter_check_parity
        max_iter = dyn_params.num_iter_max

        # round-robin deal: device d gets frames d, d+n_dev, ...
        deal = np.arange(n_pad).reshape(n_local, n_dev).T.ravel()
        pad_vals = np.zeros((self.code.n_vars, n_pad), np.float32)
        # pad frames decode instantly: all-zero bits satisfy syndrome 0,
        # so a strong negative channel value (bit 0) converges at once
        pad_vals[: self.code.n_vars - self.code.n_erased_vars, :] = -1.0
        pad_vals[:, :n_vecs] = values
        pad_syn = np.zeros((self.code.n_checks, n_pad), np.int8)
        pad_syn[:, :n_vecs] = syndromes

        vn_order = self._vn_order_io
        cn_order = self._cn_order_io
        from ldpc_decoder_tpu.parallel.mesh import batch_sharding

        pool_values = jax.device_put(
            pad_vals[vn_order][:, deal], batch_sharding(mesh, 1, 2)
        )
        pool_syn = jax.device_put(
            pad_syn[cn_order][:, deal], batch_sharding(mesh, 1, 2)
        )

        phi_pre = pre_from_infinity_threshold(dyn_params.infinity_threshold)
        burst = max(0, dyn_params.num_iter_first_check - k)
        fn = self._mesh_decode_fn(k, max_iter, n_local, mesh, phi_pre,
                                  burst)
        # compile and finish the pool upload ahead of the timed region,
        # and stop the clock before the results come back, so the stats
        # time the decode alone, as decode_presorted's do
        fn.lower(pool_values, pool_syn).compile()
        jax.block_until_ready((pool_values, pool_syn))
        t0 = time.perf_counter()
        results_sh, iters_sh, supersteps = fn(pool_values, pool_syn)
        jax.block_until_ready(results_sh)
        elapsed = time.perf_counter() - t0
        results_sh = np.asarray(results_sh)
        iters_sh = np.asarray(iters_sh)

        # reassemble: drop each device's sentinel row, undo the deal
        res = results_sh.reshape(n_dev, n_local + 1, self.n_words)[:, :-1]
        res = res.reshape(n_dev * n_local, self.n_words)
        iters = iters_sh.reshape(n_dev, n_local + 1)[:, :-1].ravel()
        inv = np.empty_like(deal)
        inv[deal] = np.arange(n_pad)
        results = res[inv][:n_vecs]
        iters = iters[inv][:n_vecs]

        supersteps = int(np.max(supersteps))
        stats = DecodeStats(
            iterations=iters,
            total_supersteps=supersteps,
            total_iterations=supersteps * k + burst,
            elapsed_seconds=elapsed,
            batch_size=self._parallel_factor * n_dev,
        )
        return results, stats

    def profile_phases(
        self,
        pool_values,
        pool_syn,
        dyn_params: DynamicParams,
        n_vecs: int,
        repeats: int = 3,
    ) -> dict[str, float]:
        """Per-phase step timing in seconds (the reference's print_time
        instrumentation of its refill steps, ldpc_decoder_gpu.cu:275-281,
        517-601, surfaced at log >= 2).

        Decomposes the superstep into: one light BP iteration, the
        parity+hard-decision overhead of the superstep's final iteration,
        the full k-iteration superstep incl. retire/refill machinery, and
        the fresh-message init that dominates a refill.
        """
        import time as _time

        k = dyn_params.num_iter_check_parity
        phi_pre = pre_from_infinity_threshold(dyn_params.infinity_threshold)
        state = self._init_state(pool_values, pool_syn, n_vecs, phi_pre)
        jax.block_until_ready(state.msgs)

        def fetch(out):
            # this runtime may elide dispatches whose outputs are never
            # materialized (block_until_ready alone is not enough) —
            # fetch one element to force real execution
            leaf = jax.tree_util.tree_leaves(out)[0]
            np.asarray(leaf[(0,) * leaf.ndim])  # tiny device-side slice

        def timeit(fn, *a):
            out = fn(*a)  # compile/warm
            fetch(out)
            t0 = _time.perf_counter()
            for _ in range(repeats):
                out = fn(*a)
            fetch(out)
            return (_time.perf_counter() - t0) / repeats

        def run_k(kk):
            return timeit(
                lambda m, l, s: self._run_iterations(
                    m, l, s, self.tables, kk, phi_pre=phi_pre
                ),
                state.msgs, state.llr, state.syn,
            )

        t1 = run_k(1)
        tk = run_k(k) if k > 1 else t1
        per_iter = (tk - t1) / (k - 1) if k > 1 else t1
        # jit the init: un-jitted it materializes every broadcast/concat
        # temp at full edge size (OOMs 10^6-bit codes at B=256)
        init_fn = jax.jit(
            lambda l: self._init_messages(
                l, self.tables, dtype=self.msg_dtype, phi_pre=phi_pre
            )
        )
        t_init = timeit(init_fn, state.llr)
        core = jax.jit(self._build_superstep(k, dyn_params.num_iter_max,
                                             n_vecs, phi_pre))
        try:
            t_super = timeit(core, state, pool_values, pool_syn)
        except jax.errors.JaxRuntimeError as e:
            # without donation the un-looped superstep holds two full
            # states; at 10^6-bit scale that can exceed device memory —
            # the fused driver's itpv covers the superstep total instead
            if "RESOURCE_EXHAUSTED" not in str(e):
                raise
            t_super = float("nan")
        return {
            "bp_iteration": per_iter,
            "parity_and_bits": max(t1 - per_iter, 0.0),
            "superstep_total": t_super,
            "retire_refill_pack": max(t_super - tk, 0.0),
            "refill_message_init": t_init,
        }

    def _init_state(self, pool_values, pool_syn, n_pool: int,
                    phi_pre: float = PRE_THRESHOLD,
                    input_is_llr: bool = False) -> DecodeState:
        b = self._parallel_factor
        frame_ids = jnp.arange(b, dtype=jnp.int32)
        active = frame_ids < n_pool
        safe = jnp.clip(frame_ids, 0, n_pool - 1)
        if n_pool == b:
            # single-fill pool: the lane->pool map is the identity — skip
            # the take (a full [n_vars, B] copy at peak memory)
            vals = pool_values
        else:
            vals = jnp.take(pool_values, safe, axis=1)
        llr = vals if input_is_llr else self.channel.llr_from_channel(vals)
        # NB this where() must stay UNCONDITIONAL: it is what makes the
        # single-fill identity-skip above (vals = pool_values) donation-
        # safe — for codes with no erasures and input_is_llr it is the
        # only op materializing a fresh buffer between the live pool
        # argument and state.llr, whose aliasing would trip the host-poll
        # superstep's donate_argnums (see the syndrome NB below).
        llr = jnp.where(self.tables.erased_mask_sorted, 0.0, llr)
        # store LLR state in the kernels' consumption dtype: they would
        # cast it every superstep (an n_vars x B conversion pass), and
        # rounding once here is bit-identical to rounding the same fp32
        # values every superstep. 1-byte messages keep bf16 LLRs (channel
        # values need more mantissa than saturating messages).
        llr = llr.astype(self._llr_dtype)
        # NB: no identity-skip for the syndrome take — state.syn aliasing
        # pool_syn trips the host-poll superstep's donate_argnums (donated
        # state leaf == live pool argument). The values path is safe
        # because the erased-mask where() above always materializes a
        # fresh buffer (and must stay unconditional, see its NB).
        syn = jnp.take(pool_syn, safe, axis=1)
        msgs = self._init_messages(llr, self.tables, dtype=self.msg_dtype,
                                   phi_pre=phi_pre)
        return DecodeState(
            msgs=msgs,
            llr=llr,
            syn=syn,
            frame_ids=frame_ids,
            iters_done=jnp.zeros(b, jnp.int32),
            active=active,
            pool_next=jnp.asarray(min(b, n_pool), jnp.int32),
            supersteps=jnp.asarray(0, jnp.int32),
            results=jnp.zeros((n_pool + 1, self.n_words), jnp.uint32),
            iters_out=jnp.zeros(n_pool + 1, jnp.int32),
            fresh=jnp.zeros(b, jnp.int8),
        )

    # ------------------------------------------------------------------
    def decode(
        self,
        dyn_params: DynamicParams,
        n_vecs: int,
        values: np.ndarray,      # [n_vars, n_vecs] float32, natural order
        syndromes: np.ndarray,   # [n_checks, n_vecs] 0/1, natural order
        input_is_llr: bool = False,
        host_poll: bool = False,  # True: one scalar readback per superstep
        progress=None,  # optional callable(n_remaining) in host_poll mode
    ) -> tuple[np.ndarray, DecodeStats]:
        """Decode ``n_vecs`` frames; returns (packed bits [n_vecs, n_words]
        uint32 in natural per-frame layout, stats).

        Input layout contract mirrors h/ldpc_decoder_gpu.h:94 transposed to
        numpy convention: ``values[i, v]`` = i-th channel value of frame v.
        """
        import time

        if values.shape != (self.code.n_vars, n_vecs):
            raise ValueError(f"values must be [{self.code.n_vars}, {n_vecs}]")
        if syndromes.shape != (self.code.n_checks, n_vecs):
            raise ValueError(
                f"syndromes must be [{self.code.n_checks}, {n_vecs}]"
            )
        # upload pools in sorted layouts (one-time permutation); the
        # tables' I/O orders fold in any detected alist renumbering
        vn_order = self._vn_order_io
        cn_order = self._cn_order_io
        pool_values = jnp.asarray(
            values[vn_order].astype(np.float32, copy=False)
        )
        pool_syn = jnp.asarray(syndromes[cn_order].astype(np.int8, copy=False))
        return self.decode_presorted(
            dyn_params, n_vecs, pool_values, pool_syn,
            host_poll=host_poll, progress=progress,
            input_is_llr=input_is_llr,
        )

    def decode_streamed(
        self,
        dyn_params: DynamicParams,
        chunks,  # iterable of (values [n_vars, n], syndromes [n_checks, n])
        input_is_llr: bool = False,
        depth: int = 2,
    ):
        """Production host-fed pipeline: overlap upload(i+1) / decode(i) /
        readback(i-1) across an iterable of frame chunks.

        The reference achieves the same overlap with explicit CUDA streams
        (ldpc_decoder_gpu.cu:218-273 uploads batch i+1 while the GPU decodes
        batch i, 464-611 reads finished frames back mid-decode). Here the
        XLA runtime's async dispatch gives it structurally: ``device_put``
        and the fused single-dispatch decode both return before the work
        completes, so this generator keeps up to ``depth`` chunks in flight
        and only blocks fetching the OLDEST chunk's results — upload and
        host-side bookkeeping of chunk i+1 proceed while chunk i decodes.

        Yields ``(results, stats)`` per chunk, in order, bit-identical to
        per-chunk ``decode()`` calls (the superstep math is untouched; only
        the host<->device scheduling changes).

        Per-chunk ``stats.elapsed_seconds`` spans dispatch->readback of that
        chunk and OVERLAPS other chunks' work — for throughput, divide total
        bits by the wall time of the whole stream, not by per-chunk sums.
        """
        import time
        from collections import deque

        k = dyn_params.num_iter_check_parity
        max_iter = dyn_params.num_iter_max
        phi_pre = pre_from_infinity_threshold(dyn_params.infinity_threshold)
        burst = max(0, dyn_params.num_iter_first_check - k)
        vn_order = self._vn_order_io
        cn_order = self._cn_order_io

        inflight: deque = deque()

        def finalize(item):
            state, n, t0 = item
            results = np.asarray(state.results)[:n]  # blocks on this chunk
            iters = np.asarray(state.iters_out)[:n]
            supersteps = int(state.supersteps)
            stats = DecodeStats(
                iterations=iters,
                total_supersteps=supersteps,
                total_iterations=supersteps * k + burst,
                elapsed_seconds=time.perf_counter() - t0,
                batch_size=self._parallel_factor,
            )
            return results, stats

        for values, syndromes in chunks:
            n = values.shape[1]
            if values.shape != (self.code.n_vars, n):
                raise ValueError(
                    f"chunk values must be [{self.code.n_vars}, n]")
            t0 = time.perf_counter()
            # async upload in sorted layouts (same contract as decode())
            pool_values = jax.device_put(
                values[vn_order].astype(np.float32, copy=False))
            pool_syn = jax.device_put(
                syndromes[cn_order].astype(np.int8, copy=False))
            run = self._full_decode_fn(k, max_iter, n, phi_pre,
                                       input_is_llr, burst)
            state = run(pool_values, pool_syn)  # async dispatch
            inflight.append((state, n, t0))
            if len(inflight) >= depth:
                yield finalize(inflight.popleft())
        while inflight:
            yield finalize(inflight.popleft())

    def decode_presorted(
        self,
        dyn_params: DynamicParams,
        n_vecs: int,
        pool_values: jnp.ndarray,  # [n_vars, n_vecs] f32, SORTED vn order
        pool_syn: jnp.ndarray,     # [n_checks, n_vecs] int8, SORTED cn order
        host_poll: bool = False,
        progress=None,
        fetch_results: bool = True,
        input_is_llr: bool = False,
    ):
        """Device-pool entry point: pools are already on device in the
        decoder's sorted layouts (e.g. produced by the on-device data
        generator) — zero host transfers before decode.

        ``input_is_llr``: pool_values are already LLRs (external channels
        with no device conversion kernel — the reference's prepare_vectors
        CPU path, ldpc_decoder_gpu.cu:199-216)."""
        import time

        k = dyn_params.num_iter_check_parity
        max_iter = dyn_params.num_iter_max
        phi_pre = pre_from_infinity_threshold(dyn_params.infinity_threshold)
        # delayed first parity check (see DynamicParams.num_iter_first_check)
        burst = max(0, dyn_params.num_iter_first_check - k)

        if host_poll:
            state = self._init_state(pool_values, pool_syn, n_vecs,
                                     phi_pre, input_is_llr)
            superstep = self._superstep_fn(k, max_iter, n_vecs, phi_pre,
                                           input_is_llr)
            t0 = time.perf_counter()
            if burst > 0:
                msgs = self._run_burst(state.msgs, state.llr, state.syn,
                                       self.tables, burst, phi_pre=phi_pre)
                state = state._replace(
                    msgs=msgs, iters_done=state.iters_done + burst)
            while True:
                state, n_remaining = superstep(state, pool_values, pool_syn)
                n = int(n_remaining)
                if progress is not None:
                    progress(n)
                if n == 0:
                    break
            jax.block_until_ready(state.results)
            elapsed = time.perf_counter() - t0
        else:
            run = self._full_decode_fn(k, max_iter, n_vecs, phi_pre,
                                       input_is_llr, burst)
            t0 = time.perf_counter()
            state = run(pool_values, pool_syn)
            jax.block_until_ready(state.results)
            elapsed = time.perf_counter() - t0

        supersteps = int(state.supersteps)
        if fetch_results:
            results = np.asarray(state.results)[:n_vecs]
            iters = np.asarray(state.iters_out)[:n_vecs]
        else:  # leave on device (e.g. for on-device error counting)
            results = state.results[:n_vecs]
            iters = np.asarray(state.iters_out)[:n_vecs]
        stats = DecodeStats(
            iterations=iters,
            total_supersteps=supersteps,
            total_iterations=supersteps * k + burst,
            elapsed_seconds=elapsed,
            batch_size=self._parallel_factor,
        )
        return results, stats
