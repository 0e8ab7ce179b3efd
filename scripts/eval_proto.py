"""FER-scan a punctured protograph candidate on the device.

Lifts a protomatrix (from scripts/optimize_proto.py) with the two-stage
girth-aware construction and measures FER/BER/iterations over a sigma
sweep — the final arbiter the P-EXIT score cannot replace (GA error
~0.005-0.01 sigma; finite-length gap on top).

Usage:
  python scripts/eval_proto.py NAME [Z] [n_frames] [sigma,sigma,...]

Candidates live in the PROTOS registry below. Codes are cached in
codes_cache/proto_<NAME>_Z<Z>.alist.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# name -> (BASE, n_punct, prelift_m, coarse, fine_mod)
PROTOS = {
    # AR4JA reference family (asymptotic sigma* 0.9309 — expected to fail
    # at 0.94; the control datapoint)
    "ar4ja": (
        np.array([[1, 2, 0, 0, 0],
                  [0, 3, 1, 1, 1],
                  [0, 1, 2, 2, 1]], dtype=np.int8),
        1, 8, 512, 64,
    ),
}


def add_candidate(name, base, n_punct, m=8, coarse=512, fine_mod=64):
    PROTOS[name] = (np.asarray(base, dtype=np.int8), n_punct, m, coarse,
                    fine_mod)


# ---- annealed candidates (scripts/optimize_proto.py outputs) ----
# (bases keep their annealed column order; punctured cols are the LAST
# n_punct columns by construction)

# 4x7, 1 punctured: constrained P-EXIT sigma* (80it) 0.9461, (120it)
# 0.9549, asymptotic 0.9619 — the round-2 flagship candidate
add_candidate("p41", [
    [0, 1, 1, 0, 1, 0, 3],
    [0, 1, 0, 1, 2, 1, 2],
    [0, 2, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 0, 0, 2],
], 1, m=8, coarse=512, fine_mod=64)

# p41 on the coarse-1024 lattice (the shipped instance's lattice)
add_candidate("p41c", [
    [0, 1, 1, 0, 1, 0, 3],
    [0, 1, 0, 1, 2, 1, 2],
    [0, 2, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 0, 0, 2],
], 1, m=8, coarse=1024, fine_mod=64)

# 5x8, 2 punctured: constrained (80it) 0.9426, (120it) 0.9555,
# asymptotic 0.9689 — more asymptotic margin, narrower tunnel than p41
add_candidate("p52b", [
    [1, 0, 0, 0, 0, 0, 1, 2],
    [0, 1, 0, 0, 0, 0, 0, 2],
    [0, 0, 0, 2, 0, 1, 1, 0],
    [0, 0, 2, 1, 2, 0, 1, 1],
    [0, 0, 0, 2, 1, 0, 1, 1],
], 2, m=8, coarse=512, fine_mod=64)

# 6x10, 2 punctured: constrained (80it) 0.9409, (120it) 0.9514
add_candidate("p62", [
    [0, 0, 0, 0, 1, 0, 2, 0, 1, 0],
    [0, 0, 1, 0, 1, 1, 0, 0, 0, 2],
    [0, 1, 0, 0, 0, 0, 2, 0, 0, 1],
    [0, 0, 0, 1, 0, 2, 0, 2, 2, 1],
    [0, 0, 1, 1, 0, 0, 0, 0, 0, 3],
    [1, 0, 1, 0, 0, 1, 2, 0, 0, 1],
], 2, m=4, coarse=512, fine_mod=64)


def main():
    from ldpc_decoder_tpu.channels import BIAWGNChannel
    from ldpc_decoder_tpu.codes.pexit import pexit_threshold
    from ldpc_decoder_tpu.codes.protographs import (
        make_protograph_code_two_stage,
    )
    from ldpc_decoder_tpu.codes.qc import load_qc_alist, write_qc_alist
    from ldpc_decoder_tpu.runtime.datagen_device import (
        count_bit_errors,
        create_pool_device,
    )
    from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams

    name = sys.argv[1]
    base, n_punct, m, coarse, fine_mod = PROTOS[name]
    Z = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    n_frames = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    sigmas = ([float(x) for x in sys.argv[4].split(",")]
              if len(sys.argv) > 4 else [0.92, 0.93, 0.94])
    alg = os.environ.get("EVAL_ALG", "sum-product")
    dtype = os.environ.get("EVAL_DTYPE", "bfloat16")
    beta = float(os.environ.get("EVAL_BETA", "0.5"))
    max_iter = int(os.environ.get("EVAL_MAX_ITER", "120"))

    R, C = base.shape
    punct = tuple(range(C - n_punct, C))
    thr80 = pexit_threshold(base, punct, lo=0.7, hi=1.0, tol=1e-3,
                            max_iters=80)
    print(f"{name}: {R}x{C} m={m} Z={Z} -> n={C*m*Z} "
          f"({n_punct*m*Z} punctured), P-EXIT sigma*(80it)={thr80:.4f}",
          flush=True)

    cache = os.path.join(os.path.dirname(__file__), "..", "codes_cache",
                         f"proto_{name}_Z{Z}.alist")
    if os.path.exists(cache):
        code, s = load_qc_alist(cache)
        print(f"loaded {cache}", flush=True)
    else:
        t0 = time.perf_counter()
        code, s = make_protograph_code_two_stage(
            base, punct, m=m, Z=Z, seed=1, coarse=coarse, fine_mod=fine_mod)
        print(f"two-stage lift: {time.perf_counter()-t0:.1f}s", flush=True)
        write_qc_alist(code, s, cache)

    for sigma in sigmas:
        ch = BIAWGNChannel(sigma)
        dec = LDPCDecoder(
            code, ch,
            StaticParams(max_log_parallel_factor_user=8,
                         message_dtype=dtype, algorithm=alg,
                         minsum_offset=beta),
            qc=s,
        )
        dyn = DynamicParams(num_iter_max=max_iter, num_iter_check_parity=10,
                            loading_factor=2, target_errors=15)
        B = dec.parallel_factor()
        n = min(n_frames, B * dyn.loading_factor)
        n = max(32, (n // 32) * 32)
        pool = create_pool_device(dec.cc, dec.tables, ch, 0, n)
        results, stats = dec.decode_presorted(
            dyn, n, pool.values_sorted, pool.syn_sorted, fetch_results=False)
        results, stats = dec.decode_presorted(
            dyn, n, pool.values_sorted, pool.syn_sorted, fetch_results=False)
        errors = np.asarray(count_bit_errors(results, pool.ref_packed))
        fer1 = float((errors > 0).mean())
        fer15 = float((errors > 15).mean())
        ber = float(errors.sum()) / (code.n_vars * n)
        mbps = code.n_vars / (stats.avg_iter * stats.iter_time_per_vector
                              * 1048576.0)
        print(f"  sigma={sigma:.3f}: FER(>0)={fer1:.4f} FER(>15)={fer15:.4f}"
              f" BER={ber:.2e} iters avg/max={stats.avg_iter:.1f}/"
              f"{stats.max_iter} B={B} n={n} {mbps:.1f} Mb/s", flush=True)
        del pool, results, dec


if __name__ == "__main__":
    main()
