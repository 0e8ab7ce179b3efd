"""Multi-device scaling benchmark harness.

One command that, pointed at N GPUs of one host, produces the scaling
artifact: builds the batch mesh per device-count rung, deals each device
its own frame-pool shard, runs the flagship configuration through the
shard_mapped fused decoder (runtime/decoder.decode_sharded — zero
cross-chip traffic in the hot loop except the while-condition psum), and
prints ONE JSON line with per-N decoding Mb/s + scaling efficiency.

The harness is validated in dry-run form on the virtual CPU mesh
(MULTICHIP_DRY=1: tiny code, timings reported but flagged meaningless —
the virtual devices share the host's cores). On hardware:

    python bench_multichip.py                 # flagship p41, all devices
    BENCH_FRAMES_PER_DEV=512 python bench_multichip.py

Structural scaling argument (why ~linear is expected): frames never span
devices; each rung's per-device work is identical to the single-chip
flagship; the only collective is one psum'd scalar per superstep
(~70-120 per decode).
"""

import json
import os
import sys
import time

import jax
import numpy as np

BASELINE_MBPS = 200.276  # single-RTX-3080 reference (BASELINE.md)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def get_config(dry: bool):
    from ldpc_decoder_tpu.channels import BIAWGNChannel
    from ldpc_decoder_tpu.runtime.params import DynamicParams

    if dry:
        from ldpc_decoder_tpu.codes.protographs import regular_base
        from ldpc_decoder_tpu.codes.qc import make_qc_code

        base = regular_base(8, 16, 3, 6, seed=3)
        code, qc = make_qc_code(base, Z=256, seed=1, coarse=128, fine_mod=4)
        dyn = DynamicParams(num_iter_max=50, num_iter_check_parity=5,
                            loading_factor=2)
        return code, qc, BIAWGNChannel(0.72), dyn, 2  # logp
    from bench import get_code

    code, qc = get_code()
    dyn = DynamicParams(
        num_iter_max=120,
        num_iter_check_parity=int(os.environ.get("BENCH_K", "14")),
        num_iter_first_check=int(os.environ.get("BENCH_FIRST_CHECK", "70")),
        loading_factor=2, target_errors=15)
    return code, qc, BIAWGNChannel(
        float(os.environ.get("BENCH_SIGMA", "0.94"))), dyn, 8


def run_rung(code, qc, channel, dyn, logp, n_dev, frames_per_dev, dtype):
    from ldpc_decoder_tpu.parallel.mesh import make_batch_mesh
    from ldpc_decoder_tpu.runtime.datagen import create_data
    from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu.runtime.params import StaticParams

    mesh = make_batch_mesh(n_dev)
    dec = LDPCDecoder(
        code, channel,
        StaticParams(max_log_parallel_factor_user=logp,
                     message_dtype=dtype),
        qc=qc)
    n = min(frames_per_dev, dec.parallel_factor() * dyn.loading_factor)
    n = max(32, (n // 32) * 32) * n_dev
    t0 = time.perf_counter()
    batch = create_data(code, channel, 0, n)
    log(f"  N={n_dev}: host datagen {n} frames "
        f"({time.perf_counter()-t0:.1f}s)")
    results, stats = dec.decode_sharded(
        dyn, n, batch.values, batch.syndromes, mesh)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ results).sum()
    frame_bits = code.n_vars
    mbps = (frame_bits * n / 1048576.0) / stats.elapsed_seconds
    log(f"  N={n_dev}: {mbps:.1f} Mb/s wall, avg_iters="
        f"{stats.avg_iter:.1f}, errors={int(errors)}, "
        f"elapsed={stats.elapsed_seconds:.2f}s")
    return mbps, stats, int(errors)


def main():
    dry = os.environ.get("MULTICHIP_DRY", "0") == "1"
    if dry:
        # self-contained dry run: force the virtual CPU mesh before any
        # backend initializes
        n_want = int(os.environ.get("MULTICHIP_DRY_DEVICES", "8"))
        jax.config.update("jax_platforms", "cpu")
        if len(jax.devices()) < n_want:
            from __graft_entry__ import _force_virtual_cpu_mesh

            _force_virtual_cpu_mesh(n_want)
    from bench import device_record
    from ldpc_decoder_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    device = device_record()
    log(f"device: {device}")
    frames_per_dev = int(os.environ.get("BENCH_FRAMES_PER_DEV", "512"))
    dtype = os.environ.get("BENCH_DTYPE", "bfloat16")
    code, qc, channel, dyn, logp = get_config(dry)

    rungs = []
    n = 1
    while n <= len(devs):
        rungs.append(n)
        n *= 2
    if rungs[-1] != len(devs):
        rungs.append(len(devs))

    per_n = {}
    errors_total = 0
    for n_dev in rungs:
        mbps, stats, errs = run_rung(code, qc, channel, dyn, logp, n_dev,
                                     frames_per_dev, dtype)
        per_n[n_dev] = mbps
        errors_total += errs

    base = per_n[rungs[0]]
    out = {
        "metric": "multichip_decoding_scaling",
        "unit": "Mb/s",
        "platform": devs[0].platform,
        "devices": rungs,
        "mbps": [round(per_n[n], 2) for n in rungs],
        "efficiency": [round(per_n[n] / (base * n), 4) for n in rungs],
        "vs_baseline": [round(per_n[n] / BASELINE_MBPS, 4) for n in rungs],
        "errors": errors_total,
        "dry_run": dry,
        "device": device,
    }
    if dry or devs[0].platform == "cpu":
        out["timings_meaningless"] = (
            "virtual CPU devices share the host's cores; correctness "
            "only — run on real GPUs for scaling numbers")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
