"""Time the Pallas Triton QC kernels against XLA's plain QC path on one GPU.

For each code and path: the per-iteration time of a burst of plain BP
iterations (no parity, no refill), the end-to-end decode of a device pool,
and, with --trace, a profiler trace of one burst reduced to per-operation
device time. Both paths run in this one process, on one card, in turns.

    python scripts/qc_kernel_timing.py [--codes p41,reg36,random36]
        [--trace DIR] [--iters 10] [--frames 512]
        [--sweep REG:LANES:WARPS[:stub],...]

--sweep times only the kernel's burst under other tile configurations
(ops/qc_triton.py's register budget, lane cap and warp count); ``stub``
replaces φ by the identity to measure φ's share of the passes.
Prints one JSON line per (code, path) and a last JSON summary line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CELLS = {
    # name: (sigma, k, first_check, frames)
    "p41": (0.94, 14, 70, 512),
    "reg36": (0.87, 10, 0, 512),
    "random36": (0.84, 10, 0, 256),
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def reduce_trace(trace_dir: str, top: int = 12) -> dict:
    """Device time per operation name in the newest trace under
    ``trace_dir`` (the sum of event durations on the GPU planes' stream
    lines), the busy time (the union of those events) and the window from
    the first event's start to the last one's end."""
    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    prof = jax.profiler.ProfileData.from_file(paths[-1])
    per_op: dict[str, float] = {}
    spans = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                per_op[ev.name] = per_op.get(ev.name, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _, e in spans) - min(s for s, _ in spans)
              if spans else 0.0)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {"device_busy_ms": busy / 1e6, "window_ms": window / 1e6,
            "idle_share": 1.0 - busy / window if window else None,
            "top_ops_ms": {k: round(v / 1e6, 3) for k, v in ops}}


def cn_pass_ms(dec, st, reps=5) -> float:
    """Seconds of one check-node pass alone on the decoder's state."""
    import jax

    from ldpc_decoder_tpu.ops import decode, qc_decode, qc_triton

    t = dec.tables
    if dec.qc is None:
        fn = jax.jit(lambda m, s: decode.cn_update(m, s, t))
        args = (st.msgs, st.syn)
    else:
        B = st.msgs.shape[-1]
        m3 = st.msgs.reshape(t.n_blocks, t.Z, B)
        s3 = st.syn.reshape(-1, t.Z, B)
        update = (qc_triton.cn_pass if dec.kernel == "triton"
                  else qc_decode.cn_update_qc)
        fn = jax.jit(lambda m, s: update(m, s, t))
        args = (m3, s3)
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def time_path(name, code, qc, impl, iters, frames, trace_dir):
    import jax

    from ldpc_decoder_tpu.channels import BIAWGNChannel
    from ldpc_decoder_tpu.runtime.datagen_device import (
        count_bit_errors,
        create_pool_device,
    )
    from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams
    from ldpc_decoder_tpu.runtime import perf

    sigma, k, fc, n_def = CELLS[name]
    n = frames or n_def
    dec = LDPCDecoder(code, BIAWGNChannel(sigma), StaticParams(
        max_log_parallel_factor_user=8, message_dtype="bfloat16",
        kernel_impl=impl, qc_autodetect=qc is not None), qc=qc)
    B = dec.parallel_factor()
    pool = create_pool_device(dec.cc, dec.tables, dec.channel, 0, n)
    st = dec._init_state(pool.values_sorted, pool.syn_sorted, n)

    def burst():
        m = dec._run_burst(st.msgs, st.llr, st.syn, dec.tables, iters)
        jax.block_until_ready(m)

    t0 = time.perf_counter()
    burst()
    t_compile = time.perf_counter() - t0
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        burst()
        reps.append((time.perf_counter() - t0) / iters)
    per_iter = float(np.median(reps))
    out = {"cell": name, "kernel": dec.kernel, "B": B,
           "per_iter_ms": per_iter * 1e3,
           "per_iter_ms_reps": [r * 1e3 for r in reps],
           "burst_compile_s": t_compile,
           "cn_pass_ms": cn_pass_ms(dec, st) * 1e3}
    out["cn_share"] = out["cn_pass_ms"] / out["per_iter_ms"]
    bpi = perf.bytes_per_iter(code.n_edges, code.n_vars, code.n_checks, B,
                              2, 2)
    out["achieved_gbps"] = bpi / per_iter / 1e9
    if trace_dir:
        d = os.path.join(trace_dir, f"{name}_{dec.kernel}")
        with jax.profiler.trace(d):
            burst()
        out["trace"] = reduce_trace(d)
    dyn = DynamicParams(num_iter_max=120, num_iter_check_parity=k,
                        num_iter_first_check=fc,
                        loading_factor=max(1, -(-n // B)))
    del st
    dec.decode_presorted(dyn, n, pool.values_sorted, pool.syn_sorted,
                         fetch_results=False)
    res, stats = dec.decode_presorted(dyn, n, pool.values_sorted,
                                      pool.syn_sorted, fetch_results=False)
    if trace_dir:
        # a whole decode, traced in a run of its own (after the timed one)
        d = os.path.join(trace_dir, f"{name}_{dec.kernel}_decode")
        with jax.profiler.trace(d):
            dec.decode_presorted(dyn, n, pool.values_sorted,
                                 pool.syn_sorted, fetch_results=False)
        out["decode_trace"] = reduce_trace(d)
    errors = np.asarray(count_bit_errors(res, pool.ref_packed))
    out.update({
        "frames": n, "fer1": float((errors > 0).mean()),
        "ber": float(errors.sum()) / (code.n_vars * n),
        "avg_iters": float(stats.avg_iter),
        "decode_mbps": code.n_vars / (stats.avg_iter
                                      * stats.iter_time_per_vector
                                      * 1048576.0),
        "e2e_mbps": code.n_vars * n / 1048576.0 / stats.elapsed_seconds,
        "peak_bytes": (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"),
    })
    print(json.dumps(out), flush=True)
    return out


def sweep(code, qc, configs, iters):
    """Per-iteration burst time of the kernel under each configuration."""
    import jax

    from ldpc_decoder_tpu.ops import qc_triton
    from ldpc_decoder_tpu.ops.phi import phi_abs

    from ldpc_decoder_tpu.channels import BIAWGNChannel
    from ldpc_decoder_tpu.runtime.datagen_device import create_pool_device
    from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu.runtime.params import StaticParams

    dec = LDPCDecoder(code, BIAWGNChannel(0.94), StaticParams(
        max_log_parallel_factor_user=8, message_dtype="bfloat16",
        kernel_impl="pallas"), qc=qc)
    B = dec.parallel_factor()
    pool = create_pool_device(dec.cc, dec.tables, dec.channel, 0, B)
    st = dec._init_state(pool.values_sorted, pool.syn_sorted, B)
    saved = (qc_triton._REG_ELEMS, qc_triton._MAX_LANES,
             qc_triton._NUM_WARPS, qc_triton.phi_abs)
    out = []
    for cfg in configs:
        parts = cfg.split(":")
        qc_triton._REG_ELEMS, qc_triton._MAX_LANES = (int(parts[0]),
                                                      int(parts[1]))
        qc_triton._NUM_WARPS = int(parts[2])
        qc_triton.phi_abs = ((lambda x, pre: x) if "stub" in parts
                             else phi_abs)
        qc_triton.burst_iterations_qc_triton.clear_cache()

        def burst():
            jax.block_until_ready(dec._run_burst(
                st.msgs, st.llr, st.syn, dec.tables, iters))

        burst()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            burst()
            reps.append((time.perf_counter() - t0) / iters * 1e3)
        r = {"sweep": cfg, "per_iter_ms": float(np.median(reps)),
             "reps_ms": reps}
        print(json.dumps(r), flush=True)
        out.append(r)
    (qc_triton._REG_ELEMS, qc_triton._MAX_LANES, qc_triton._NUM_WARPS,
     qc_triton.phi_abs) = saved
    qc_triton.burst_iterations_qc_triton.clear_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--codes", default="p41,reg36")
    ap.add_argument("--paths", default="pallas,xla")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--trace", default="")
    ap.add_argument("--sweep", default="")
    args = ap.parse_args()

    from bench import device_record, get_code, get_random36_code
    from bench import get_reg36_code
    from ldpc_decoder_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = device_record()
    log(f"device: {device}")
    results = []
    if args.sweep:
        code, qc = get_code()
        sweep(code, qc, args.sweep.split(","), args.iters)
    for name in args.codes.split(","):
        if name == "p41":
            code, qc = get_code()
        elif name == "reg36":
            code, qc = get_reg36_code()
        else:
            code, qc = get_random36_code(), None
        for impl in args.paths.split(","):
            if qc is None and impl == "pallas":
                continue
            results.append(time_path(name, code, qc, impl, args.iters,
                                     args.frames, args.trace))
    print(json.dumps({"device": device, "results": [
        {k: r[k] for k in ("cell", "kernel", "per_iter_ms", "decode_mbps",
                           "e2e_mbps", "fer1")} for r in results]}))


if __name__ == "__main__":
    main()
