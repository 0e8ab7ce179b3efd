"""Flagship benchmark: the reference's own operating point, matched.

Headline: decoding throughput of the punctured p41 code (n = 1,032,192,
147,456 punctured, sigma <= 0.95) at noise sigma = 0.94 — exactly the
reference's flagship configuration (README.md:56, 68-107: RTX 3080, CUDA
fp16, 2^20-bit rate-0.5 AWGN code, sigma 0.94, 256 frames resident,
loading factor 2, -e 15 -i 120). Baseline: 200.276 Mb/s steady-state
decoding throughput (BASELINE.md). Error rates are part of the metric:
the reference reports FER(>=1) 0.047 / BER 2.29e-7 there; this code
measures FER 0 / BER 0 at the same point (and still FER 0 at 0.95, the
reference code's correction limit) — see codes/protographs.py:P41_BASE.

Prints ONE JSON line naming the device it ran on:
  {"metric": ..., "value": N, "unit": "Mb/s", "vs_baseline": N/200.276,
   "fer1": ..., "fer15": ..., "ber": ..., "avg_iters": ...,
   "device": {"platform", "kind", "count", "card"}}

Secondary datapoints (stderr): the regular (3,6) 2^20 code at its own
near-threshold point, and optionally min-sum. A failing phase fails the
run.

Env knobs: BENCH_SIGMA, BENCH_DTYPE (bfloat16|float32), BENCH_ALG
(sum-product|min-sum), BENCH_FRAMES, BENCH_LOGP (log2 lanes, default 8 =
the reference's -p 8), BENCH_SECONDARY=0 to skip the secondary
datapoints.
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_MBPS = 200.276  # README.md:106 (steady-state decoding)
BASELINE_E2E_MBPS = 159.456  # README.md:103 (incl. transfers & finish)
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "codes_cache")
P41_ALIST = os.path.join(CACHE, "code_awgn_rate_0.5_thr_0.95.alist")
REG36_ALIST = os.path.join(CACHE, "bench_qc36x_awgn_r05_1048576_g8.alist")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def get_code():
    """The flagship punctured code (p41; codes/protographs.py)."""
    from ldpc_decoder_tpu.codes.protographs import p41_code, p41_shipped_params
    from ldpc_decoder_tpu.codes.qc import (
        load_qc_alist,
        read_alist_params,
        write_qc_alist,
    )

    want = p41_shipped_params()
    if os.path.exists(P41_ALIST):
        # the filename encodes neither seed nor lattice — verify the
        # #params construction header so a stale cache (e.g. the round-2
        # seed-1/coarse-512 build) is regenerated, not silently
        # benchmarked as the shipped instance
        have = read_alist_params(P41_ALIST)
        if have == want:
            log(f"loading cached code {P41_ALIST}")
            code, s = load_qc_alist(P41_ALIST)
            if s is not None:
                return code, s
        else:
            log(f"cached {P41_ALIST} params {have} != shipped {want}; "
                f"regenerating")
    log("generating flagship punctured code (p41, n=1032192, girth-8 "
        "two-stage lift)...")
    code, s = p41_code()
    os.makedirs(CACHE, exist_ok=True)
    write_qc_alist(code, s, P41_ALIST, params=want)
    return code, s


def get_reg36_code():
    """The regular (3,6) 2^20 seam-lattice code (round-1 flagship)."""
    from ldpc_decoder_tpu.codes.protographs import regular_base
    from ldpc_decoder_tpu.codes.qc import (
        load_qc_alist,
        make_qc_code,
        write_qc_alist,
    )

    want = {"base": "reg36_16x32_s2", "Z": "32768", "seed": "1",
            "coarse": "1024", "fine_mod": "64", "min_girth": "8"}
    if os.path.exists(REG36_ALIST):
        from ldpc_decoder_tpu.codes.qc import read_alist_params

        if read_alist_params(REG36_ALIST) == want:
            code, s = load_qc_alist(REG36_ALIST)
            if s is not None:
                return code, s
        log(f"cached {REG36_ALIST} params mismatch; regenerating")
    base = regular_base(16, 32, 3, 6, seed=2)
    code, s = make_qc_code(base, Z=32768, seed=1, coarse=1024,
                           fine_mod=64, min_girth=8)
    write_qc_alist(code, s, REG36_ALIST, params=want)
    return code, s


def get_random36_code():
    """The random (non-QC) (3,6) 2^20 alist of the general-path cell."""
    from ldpc_decoder_tpu.codes.generate import make_regular_code

    return make_regular_code(1 << 20, 3, 6, seed=9)


def card_info() -> str:
    """``name, power.limit`` from nvidia-smi, run as a child process that
    never imports JAX (empty when there is no nvidia-smi)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def device_record() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_info()}


def run_point(code, qc, sigma, dtype, alg, n_frames, max_iter=120,
              check_period=10, hostfed=False, first_check=0):
    """Decode n_frames at sigma; returns (dec_mbps, e2e_mbps, stats dict).

    ``hostfed``: additionally decode the SAME pool through the host-data
    entry point ``decode()`` — frames uploaded from host numpy and results
    read back — timing the full round trip. This is the reference's own
    end-to-end definition (its 159.456 Mb/s includes every frame's
    host->device LLR/syndrome upload and the result readback,
    ldpc_decoder_gpu.cu:218-273); the on-device-datagen e2e number has
    nothing to transfer, so this is the apples-to-apples companion.
    """
    from ldpc_decoder_tpu.channels import BIAWGNChannel
    from ldpc_decoder_tpu.runtime.datagen_device import (
        count_bit_errors,
        create_pool_device,
    )
    from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams

    channel = BIAWGNChannel(sigma)
    # -p analog: 8 -> B=256, the reference's own flagship lane count
    logp = int(os.environ.get("BENCH_LOGP", "8"))
    dec = LDPCDecoder(
        code, channel,
        StaticParams(max_log_parallel_factor_user=logp, message_dtype=dtype,
                     algorithm=alg),
        qc=qc,
    )
    B = dec.parallel_factor()
    # loading factor grows with the requested frame count (the reference's
    # flagship number is steady-state over a 2560-frame run, main.cpp:320;
    # a larger pool amortizes the end-of-pool partially-empty supersteps)
    lf = max(2, -(-n_frames // B))
    dyn = DynamicParams(num_iter_max=max_iter,
                        num_iter_check_parity=check_period,
                        num_iter_first_check=first_check,
                        loading_factor=lf, target_errors=15)
    n = min(n_frames, B * dyn.loading_factor)
    n = (n // 32) * 32
    log(f"sigma={sigma} dtype={dtype} alg={alg} B={B} frames={n}")

    t0 = time.perf_counter()
    pool = create_pool_device(dec.cc, dec.tables, channel, 0, n)
    pool.values_sorted.block_until_ready()
    log(f"on-device datagen: {time.perf_counter()-t0:.1f}s")

    t0 = time.perf_counter()
    _ = dec.decode_presorted(dyn, n, pool.values_sorted, pool.syn_sorted,
                             fetch_results=False)
    log(f"decode 1 (incl. compile): {time.perf_counter()-t0:.1f}s")

    results, stats = dec.decode_presorted(
        dyn, n, pool.values_sorted, pool.syn_sorted, fetch_results=False
    )
    errors = np.asarray(count_bit_errors(results, pool.ref_packed))

    frame_bits = code.n_vars
    itpv = stats.iter_time_per_vector
    dec_mbps = frame_bits / (stats.avg_iter * itpv * 1048576.0)
    e2e_mbps = (frame_bits * n / 1048576.0) / stats.elapsed_seconds
    out = {
        "fer1": float((errors > 0).mean()),
        "fer15": float((errors > 15).mean()),
        "ber": float(errors.sum()) / (frame_bits * n),
        "avg_iters": round(stats.avg_iter, 2),
        "max_iters": stats.max_iter,
        "min_iters": stats.min_iter,
        "itpv": itpv,
        "elapsed": stats.elapsed_seconds,
        "B": B,
        "n": n,
    }
    # first-check taint guard: when the whole batch
    # retires within one check period of the delayed first check, the
    # burst may have idled frames that converged much earlier — the
    # number is deflated (never wrong, just pessimistic). This is
    # EXPECTED at the qualified flagship point (p41 at sigma>=0.94:
    # measured true convergence min is 61, so checks before 70 are
    # futile — fer_stats over 2048 frames); anywhere else it means the
    # operator should rerun with first_check=0.
    if first_check:
        out["first_check"] = first_check
        if stats.min_iter <= first_check and sigma < 0.94:
            out["first_check_suspect"] = True
            log(f"WARNING: min_iters={stats.min_iter} <= "
                f"first_check={first_check} at sigma={sigma} (below the "
                f"qualified flagship point): frames retired at the first "
                f"allowed parity check — the delayed-first-check burst "
                f"likely DEFLATED this number; rerun with "
                f"BENCH_FIRST_CHECK=0 for this (code, sigma)")

    # bytes the algorithm moves per iteration (runtime/perf.py) over the
    # measured per-iteration time
    from ldpc_decoder_tpu.runtime import perf

    msg_bytes = {"bfloat16": 2, "float8_e5m2": 1, "int8": 1}.get(dtype, 4)
    bpi = perf.bytes_per_iter(code.n_edges, code.n_vars, code.n_checks, B,
                              msg_bytes, np.dtype(dec._llr_dtype).itemsize)
    out["bytes_per_iter"] = bpi
    out["achieved_gbps"] = round(bpi / (itpv * B) / 1e9, 1)
    out["kernel"] = dec.kernel
    log(f"traffic: {bpi/1e9:.2f} GB/iter -> achieved "
        f"{out['achieved_gbps']} GB/s ({dec.kernel})")

    if hostfed:
        # natural-order host copies (the un-permuted layout an external
        # producer would hand the decoder: h/ldpc_decoder_gpu.h:94)
        nh = min(n, int(os.environ.get("BENCH_HOSTFED_FRAMES", "64")))
        vn_order = np.asarray(dec.tables.vn_order)
        cn_order = np.asarray(dec.tables.cn_order)
        vals_nat = np.empty((code.n_vars, nh), np.float32)
        vals_nat[vn_order] = np.asarray(pool.values_sorted[:, :nh])
        syn_nat = np.empty((code.n_checks, nh), np.int8)
        syn_nat[cn_order] = np.asarray(pool.syn_sorted[:, :nh])
        _ = dec.decode(dyn, nh, vals_nat, syn_nat)  # warm/compile path
        t0 = time.perf_counter()
        res_h, st_h = dec.decode(dyn, nh, vals_nat, syn_nat)
        wall = time.perf_counter() - t0
        # sanity: host-fed results must equal the device-pool results
        # (the first nh frames are first-generation lanes on both paths)
        # — a divergence must never publish a throughput number
        same = np.array_equal(np.asarray(results[:nh]), res_h)
        if not same:
            raise RuntimeError(
                "host-fed decode() results diverge from the device-pool "
                "decode_presorted() results — decode-path bug, refusing "
                "to publish bench numbers")
        out["e2e_hostfed_mbps"] = round(
            (frame_bits * nh / 1048576.0) / wall, 2)
        out["e2e_hostfed_frames"] = nh
        log(f"host-fed e2e (upload + decode + readback, {nh} frames, "
            f"results match device path: {same}): "
            f"{out['e2e_hostfed_mbps']} Mb/s over {wall:.2f}s "
            f"(reference e2e 159.456 Mb/s, README.md:103)")

        # production pipeline datapoint: the SAME frames through
        # decode_streamed over >=4 chunks vs a serial per-chunk decode()
        # loop (upload of chunk i+1 overlaps decode of chunk i)
        ns = min(nh, int(os.environ.get("BENCH_STREAM_FRAMES", "16")))
        nch = int(os.environ.get("BENCH_STREAM_CHUNKS", "4"))
        chunks = [(np.ascontiguousarray(vals_nat[:, i * ns:(i + 1) * ns]),
                   np.ascontiguousarray(syn_nat[:, i * ns:(i + 1) * ns]))
                  for i in range(min(nch, nh // ns))]
        dec.decode(dyn, ns, *chunks[0])  # compile the chunk-sized decode
        t0 = time.perf_counter()
        serial = [dec.decode(dyn, v.shape[1], v, s) for v, s in chunks]
        wall_serial = time.perf_counter() - t0
        t0 = time.perf_counter()
        streamed = list(dec.decode_streamed(dyn, iter(chunks)))
        wall_stream = time.perf_counter() - t0
        for (rs, _), (rt, _) in zip(serial, streamed):
            if not np.array_equal(rs, rt):
                raise RuntimeError(
                    "decode_streamed results diverge from per-chunk "
                    "decode() — pipeline bug, refusing to publish")
        bits = frame_bits * sum(v.shape[1] for v, _ in chunks) / 1048576.0
        out["e2e_streamed_mbps"] = round(bits / wall_stream, 2)
        out["e2e_serial_chunked_mbps"] = round(bits / wall_serial, 2)
        chunk_walls = [round(st.elapsed_seconds, 2) for _, st in streamed]
        log(f"streamed pipeline ({len(chunks)} chunks x {ns} frames, "
            f"results == serial): streamed {out['e2e_streamed_mbps']} vs "
            f"serial {out['e2e_serial_chunked_mbps']} Mb/s "
            f"(walls {wall_stream:.2f}s vs {wall_serial:.2f}s; per-chunk "
            f"dispatch->readback spans {chunk_walls}s — overlapping)")
    log(
        f"decode: {out['elapsed']:.2f}s, iters avg/max/min = "
        f"{out['avg_iters']}/{out['max_iters']}/{out['min_iters']}, "
        f"itpv={itpv:.3e}s, BER={out['ber']:.3e} "
        f"FER(>0)={out['fer1']:.4f} FER(>15)={out['fer15']:.4f}"
    )
    log(f"decoding throughput: {dec_mbps:.1f} Mb/s; "
        f"end-to-end {e2e_mbps:.1f} Mb/s")
    return dec_mbps, e2e_mbps, out


def main():
    t_all = time.perf_counter()
    from ldpc_decoder_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = device_record()
    log(f"device: {device}")
    # on-device φ numerics guard: fail the whole bench rather than publish
    # a collapsed-FER number
    if os.environ.get("BENCH_SMOKE", "1") != "0":
        from ldpc_decoder_tpu.runtime.smoke import phi_numerics_smoke

        phi_numerics_smoke(log)
    sigma = float(os.environ.get("BENCH_SIGMA", "0.94"))
    dtype = os.environ.get("BENCH_DTYPE", "bfloat16")
    alg = os.environ.get("BENCH_ALG", "sum-product")
    n_frames = int(os.environ.get("BENCH_FRAMES", "512"))
    check_period = int(os.environ.get("BENCH_K", "14"))
    # first parity check at iteration 70 (grid {70, 84, ...}): no p41
    # frame converges before ~60 iterations at sigma >= 0.94 (fer_stats
    # over 2048 frames: quantized retire-min 70), so the checks before 70
    # are futile and their emit/parity/machinery cost is skipped (see
    # DynamicParams.num_iter_first_check). Harmless if wrong: a frame
    # converging early just retires at 70. The default is qualified only
    # for p41 at sigma >= 0.94; at lower noise frames converge far earlier
    # and a 70-iteration burst would idle them, so it auto-zeroes there.
    # BENCH_FIRST_CHECK overrides explicitly.
    fc_env = os.environ.get("BENCH_FIRST_CHECK")
    if fc_env is not None:
        first_check = int(fc_env)
    else:
        first_check = 70 if sigma >= 0.94 else 0
        if first_check == 0:
            log(f"first_check auto-zeroed: sigma={sigma} is below the "
                f"qualified flagship point (0.94)")

    code, qc = get_code()
    hostfed = os.environ.get("BENCH_HOSTFED", "1") != "0"
    dec_mbps, e2e_mbps, st = run_point(
        code, qc, sigma, dtype, alg, n_frames, check_period=check_period,
        hostfed=hostfed, first_check=first_check)

    fer_matched = {}
    if os.environ.get("BENCH_FERMATCHED", "1") != "0":
        # throughput at p41's FER-matched point: the sigma where THIS
        # code's FER(>=1) equals the reference's 0.047 at ITS operating
        # point — the equal-reliability throughput comparison. Located
        # by a scripts/fer_stats.py sweep: FER 0.0044 at 0.952 and ~0.05
        # near 0.953.
        sig_fm = float(os.environ.get("BENCH_FERMATCHED_SIGMA", "0.953"))
        mb_fm, _, st_fm = run_point(code, qc, sig_fm, dtype, alg,
                                    n_frames,
                                    check_period=check_period,
                                    first_check=first_check)
        # all three reliability metrics, not just FER(>=1): at the
        # FER1-matched sigma the FER15/BER are WORSE than the
        # reference's — export them so the
        # comparison is honest
        fer_matched = {"fer_matched_mbps": round(mb_fm, 2),
                       "fer_matched_sigma": sig_fm,
                       "fer_matched_fer1": st_fm["fer1"],
                       "fer_matched_fer15": st_fm["fer15"],
                       "fer_matched_ber": st_fm["ber"]}
        log(f"FER-matched point (sigma {sig_fm}): {mb_fm:.1f} Mb/s at "
            f"FER(>0) {st_fm['fer1']:.4f} FER(>15) {st_fm['fer15']:.4f} "
            f"BER {st_fm['ber']:.2e} (reference: 200.276 Mb/s at "
            f"0.047/0.00195/2.29e-7), {mb_fm / BASELINE_MBPS:.2f}x "
            f"baseline")
        # the all-metric-DOMINATING point: the sigma where every
        # reliability metric is <= the reference's at a strictly
        # harder channel than its 0.94 (frontier-qualified at 2048
        # frames: FER1 0.0049 / FER15 0.00195 / BER 2.16e-7 at 0.952)
        sig_dom = float(os.environ.get("BENCH_DOMINATING_SIGMA",
                                       "0.952"))
        mb_dom, _, st_dom = run_point(code, qc, sig_dom, dtype, alg,
                                      n_frames,
                                      check_period=check_period,
                                      first_check=first_check)
        fer_matched.update({
            "dominating_mbps": round(mb_dom, 2),
            "dominating_sigma": sig_dom,
            "dominating_fer1": st_dom["fer1"],
            "dominating_fer15": st_dom["fer15"],
            "dominating_ber": st_dom["ber"]})
        log(f"dominating point (sigma {sig_dom}): {mb_dom:.1f} Mb/s at "
            f"FER(>0) {st_dom['fer1']:.4f} FER(>15) "
            f"{st_dom['fer15']:.4f} BER {st_dom['ber']:.2e}, "
            f"{mb_dom / BASELINE_MBPS:.2f}x baseline")

    if os.environ.get("BENCH_SECONDARY", "1") != "0":
        import gc

        gc.collect()
        # raw regular-kernel speed showcase: the (3,6) 2^20 code near
        # its own threshold (sigma* ~ 0.879); NOT Shannon-matched with
        # the headline — reported for kernel-speed comparison only
        code36, qc36 = get_reg36_code()
        mb36, _, st36 = run_point(code36, qc36, 0.87, dtype, alg,
                                  n_frames)
        log(f"secondary ((3,6) 2^20 @ 0.87, 86.3% of Shannon): "
            f"{mb36:.1f} Mb/s, FER(>0) {st36['fer1']:.4f}, "
            f"{mb36 / BASELINE_MBPS:.2f}x baseline")

    log(f"total wall {time.perf_counter()-t_all:.1f}s")
    print(json.dumps({
        "metric": "decoding_throughput_1Mbit_rate0.5_awgn_sigma0.94",
        "value": round(dec_mbps, 2),
        "unit": "Mb/s",
        "vs_baseline": round(dec_mbps / BASELINE_MBPS, 4),
        # end-to-end wall throughput (the reference's "including
        # transfers and finish" number, README.md:103: 159.456 Mb/s) —
        # our pool is generated on device, so there is nothing to
        # transfer before decode
        "e2e_mbps": round(e2e_mbps, 2),
        "vs_baseline_e2e": round(e2e_mbps / BASELINE_E2E_MBPS, 4),
        "fer1": st["fer1"],
        "fer15": st["fer15"],
        "ber": st["ber"],
        "avg_iters": st["avg_iters"],
        "ref_fer1": 0.046875,
        "ref_avg_iters": 90.7148,
        # bytes the algorithm moves per iteration (runtime/perf.py) and
        # the rate they were moved at
        "bytes_per_iter": st.get("bytes_per_iter"),
        "achieved_gbps": st.get("achieved_gbps"),
        "kernel": st.get("kernel"),
        # host-fed end-to-end: upload + decode + readback through
        # decode(), the reference's transfer-inclusive definition
        "e2e_hostfed_mbps": st.get("e2e_hostfed_mbps"),
        # the production pipeline (decode_streamed, >=4 chunks) vs the
        # same chunks decoded serially — overlap delta on real hardware
        "e2e_streamed_mbps": st.get("e2e_streamed_mbps"),
        "e2e_serial_chunked_mbps": st.get("e2e_serial_chunked_mbps"),
        # equal-reliability comparison: throughput at the
        # sigma where this code's FER(>=1) matches the reference's 0.047
        **fer_matched,
        "device": device,
    }))


if __name__ == "__main__":
    main()
