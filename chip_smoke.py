"""Smoke test of the decoder on one NVIDIA GPU, at full width.

Runs, in one process, through the entry points a user calls:

1. device    — finds the GPU; the card's name and power limit come from
               nvidia-smi in a child process that never imports JAX;
2. numerics  — the φ check of runtime/smoke.py on the card;
3. kernel    — the Pallas Triton kernels against the XLA oracle on p41
               (n = 1,032,192, B = 256, bf16), from the same state;
4. end to end — LDPCDecoder with on-device datagen: p41 at σ 0.94, the
               (3,6) 2^20 QC code at σ 0.87 and the random (3,6) 2^20
               alist on the general path at σ 0.84; host-fed decode() and
               decode_streamed() checked equal to the device pool; the CLI.

``--multi`` runs only decode_sharded of p41 over a 4-device batch mesh and
the one-device decode of the same frames it is compared with.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --multi    # four GPUs

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
any failed phase exits non-zero. The phase functions take their sizes as
arguments so the tests can run them on tiny codes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

P41 = dict(sigma=0.94, k=14, first_check=70, max_iter=120, frames=512)
# One check-node pass of the kernel against the oracle's, from the same
# messages: both evaluate φ in f32, with different GPU tanh, log and exp
# implementations and sum orders (a few f32 ulps apart), and rounding to
# the storage dtype turns that into at most one ulp of the stored message.
CN_PASS_ULP_TOL = 1
# After k more iterations of each path, the share of hard decisions that
# differ: BP near threshold amplifies those last-bit differences. Measured
# 2.2e-4 on p41 at σ 0.94 (5 + 14 iterations, B = 256, an H100 at 400 W);
# the bound leaves 10x headroom.
K_ITER_BIT_DISAGREEMENT_TOL = 2.2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    """``name, power.limit`` of every card (bench.card_info: nvidia-smi in
    a child process that never imports JAX)."""
    from bench import card_info as read

    info = read()
    assert info, "nvidia-smi gave no card name and power limit"
    return info


def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {devs[0].platform} devices only")
    log(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}")
    return devs


def phase_numerics() -> dict:
    from ldpc_decoder_tpu.runtime.smoke import phi_numerics_smoke

    return phi_numerics_smoke(log)


def _decoder(code, qc, sigma, logp, dtype="bfloat16", **sp):
    from ldpc_decoder_tpu.channels import BIAWGNChannel
    from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu.runtime.params import StaticParams

    return LDPCDecoder(code, BIAWGNChannel(sigma), StaticParams(
        max_log_parallel_factor_user=logp, message_dtype=dtype, **sp),
        qc=qc)


def _pool(dec, n):
    from ldpc_decoder_tpu.runtime.datagen_device import create_pool_device

    pool = create_pool_device(dec.cc, dec.tables, dec.channel, 0, n)
    pool.values_sorted.block_until_ready()
    return pool


def _ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Units in the last place between two arrays of one float dtype; the
    plain difference for integer (int8) messages."""
    if a.dtype.kind in "iu":
        return np.abs(a.astype(np.int64) - b.astype(np.int64))
    bits = {2: np.int16, 4: np.int32}[a.dtype.itemsize]

    def ordered(x):
        # sign-magnitude bit patterns -> integers one apart per ulp
        i = x.view(bits).astype(np.int64)
        return np.where(i < 0, np.iinfo(bits).min - i, i)

    return np.abs(ordered(a) - ordered(b))


def phase_kernel_vs_oracle(code, qc, sigma, logp, k, warm=5,
                           dtype="bfloat16", interpret=False) -> dict:
    """The kernels against the XLA oracle from the same state (``warm``
    kernel iterations from the channel init): one check-node pass must
    agree within CN_PASS_ULP_TOL on every message, and after ``k`` further
    iterations of each path the hard decisions within
    K_ITER_BIT_DISAGREEMENT_TOL."""
    import jax

    from ldpc_decoder_tpu.ops import qc_decode, qc_triton

    dec_t = _decoder(code, qc, sigma, logp, dtype, kernel_impl="pallas",
                     pallas_interpret=interpret)
    dec_x = _decoder(code, qc, sigma, logp, dtype, kernel_impl="xla")
    B = dec_t.parallel_factor()
    t = dec_t.tables
    pool = _pool(dec_t, B)
    st = dec_t._init_state(pool.values_sorted, pool.syn_sorted, B)
    m_v = dec_t._run_burst(st.msgs, st.llr, st.syn, t, warm)
    m_v = m_v.reshape(t.n_blocks, t.Z, B)
    syn3 = st.syn.reshape(-1, t.Z, B)
    m_c = jax.jit(qc_decode.vn_to_cn)(m_v, t)  # the oracle's layout
    r_t = qc_triton.cn_pass(m_v, syn3, t, interpret=interpret)
    r_x = jax.jit(qc_decode.cn_update_qc)(m_c, syn3, t)
    ulps = _ulp_distance(np.asarray(r_t), np.asarray(r_x))
    out = {"cn_pass_max_ulps": int(ulps.max()),
           "cn_pass_msgs_differing": float((ulps > 0).mean())}
    del ulps, r_t, r_x
    _, b_t, v_t = dec_t._run_iterations(m_v.reshape(-1, B), st.llr, st.syn,
                                        t, k)
    _, b_x, v_x = dec_x._run_iterations(m_c.reshape(-1, B), st.llr, st.syn,
                                        dec_x.tables, k)
    bt, bx = np.asarray(b_t), np.asarray(b_x)
    out.update({
        "k": k,
        "k_iter_bit_disagreement": float((bt != bx).mean()),
        "k_iter_frames_differing": int((bt != bx).any(axis=0).sum()),
        "k_iter_violated_equal": bool(np.array_equal(v_t, v_x)),
    })
    log(f"kernel vs oracle ({code.n_vars} bits, B={B}, {dtype}): "
        f"{json.dumps(out)}")
    assert out["cn_pass_max_ulps"] <= CN_PASS_ULP_TOL, out
    assert (out["k_iter_bit_disagreement"]
            <= K_ITER_BIT_DISAGREEMENT_TOL), out
    return out


def phase_end_to_end(name, code, qc, sigma, logp, n_frames, k, max_iter,
                     first_check=0, dtype="bfloat16",
                     **sp) -> tuple[dict, object, object, object]:
    """Decode ``n_frames`` generated on the device; ``sp`` are extra
    StaticParams. Returns (stats, decoder, dynamic params, (pool, device
    results))."""
    import jax

    from ldpc_decoder_tpu.runtime.datagen_device import count_bit_errors
    from ldpc_decoder_tpu.runtime.params import DynamicParams

    dec = _decoder(code, qc, sigma, logp, dtype, **sp)
    B = dec.parallel_factor()
    lf = max(1, -(-n_frames // B))
    dyn = DynamicParams(num_iter_max=max_iter, num_iter_check_parity=k,
                        num_iter_first_check=first_check, loading_factor=lf,
                        target_errors=15)
    t0 = time.perf_counter()
    pool = _pool(dec, n_frames)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec.decode_presorted(dyn, n_frames, pool.values_sorted, pool.syn_sorted,
                         fetch_results=False)
    t_first = time.perf_counter() - t0
    results, stats = dec.decode_presorted(
        dyn, n_frames, pool.values_sorted, pool.syn_sorted,
        fetch_results=False)
    errors = np.asarray(count_bit_errors(results, pool.ref_packed))
    bits = code.n_vars
    dev = jax.devices()[0]
    mem = dev.memory_stats() or {}
    out = {
        "cell": name, "kernel": dec.kernel, "B": B, "frames": n_frames,
        "sigma": sigma,
        "fer1": float((errors > 0).mean()),
        "fer15": float((errors > 15).mean()),
        "ber": float(errors.sum()) / (bits * n_frames),
        "avg_iters": float(stats.avg_iter),
        "decode_mbps": bits / (stats.avg_iter * stats.iter_time_per_vector
                               * 1048576.0),
        "e2e_mbps": bits * n_frames / 1048576.0 / stats.elapsed_seconds,
        "elapsed_s": stats.elapsed_seconds,
        "datagen_s": t_gen, "first_decode_s": t_first,
        "peak_bytes": mem.get("peak_bytes_in_use"),
    }
    log(f"end to end [{name}]: {json.dumps(out)}")
    return out, dec, dyn, (pool, np.asarray(results))


def phase_host_fed(dec, dyn, pool, results_dev, n=64, chunk=16) -> dict:
    """decode() and decode_streamed() of the pool's first ``n`` frames,
    uploaded from the host in natural order, must equal the device-pool
    results: the first n frames are first-generation lanes on both paths,
    so they run the same iteration schedule."""
    vn_order = np.asarray(dec.tables.vn_order)
    cn_order = np.asarray(dec.tables.cn_order)
    vals = np.empty((dec.code.n_vars, n), np.float32)
    vals[vn_order] = np.asarray(pool.values_sorted[:, :n])
    syn = np.empty((dec.code.n_checks, n), np.int8)
    syn[cn_order] = np.asarray(pool.syn_sorted[:, :n])
    dec.decode(dyn, n, vals, syn)  # compile
    t0 = time.perf_counter()
    res, _ = dec.decode(dyn, n, vals, syn)
    wall = time.perf_counter() - t0
    assert np.array_equal(res, results_dev[:n]), "decode() != device pool"
    chunks = [(np.ascontiguousarray(vals[:, i:i + chunk]),
               np.ascontiguousarray(syn[:, i:i + chunk]))
              for i in range(0, n, chunk)]
    list(dec.decode_streamed(dyn, iter(chunks[:1])))  # compile
    t0 = time.perf_counter()
    streamed = [r for r, _ in dec.decode_streamed(dyn, iter(chunks))]
    wall_s = time.perf_counter() - t0
    assert np.array_equal(np.concatenate(streamed), results_dev[:n]), (
        "decode_streamed() != device pool")
    mbit = dec.code.n_vars * n / 1048576.0
    out = {"frames": n, "hostfed_mbps": mbit / wall,
           "streamed_mbps": mbit / wall_s, "equal_to_device_pool": True}
    log(f"host-fed: {json.dumps(out)}")
    return out


def phase_cli(alist: str, sigma: float, logp: int, loading: int,
              max_iter: int, extra=()) -> int:
    """cli.main in-process; returns its exit code."""
    from ldpc_decoder_tpu import cli

    argv = ["-f", alist, "-c", "1", "-n", str(sigma), "-p", str(logp),
            "-m", str(loading), "-e", "15", "-i", str(max_iter),
            "--dtype", "bfloat16", *extra]
    log(f"cli: {' '.join(argv)}")
    rc = cli.main(argv)
    assert rc == 0, f"cli.main returned {rc}"
    return rc


def phase_multi(code, qc, sigma, logp, n_devices, frames_per_device, k,
                max_iter, first_check=0, **sp) -> dict:
    """decode_sharded over an ``n_devices`` batch mesh against the
    one-device decode of the same frames. Both must decode every frame to
    the transmitted bits. Lane placement differs between the two (a frame
    that is first-generation on one side may be a refill on the other), so
    per-frame iteration counts may differ by up to k, and a refilled frame
    gets num_iter_max - 1 iterations; decoded bits are compared exactly."""
    from ldpc_decoder_tpu.parallel.mesh import make_batch_mesh
    from ldpc_decoder_tpu.runtime.params import DynamicParams

    mesh = make_batch_mesh(n_devices)
    dec = _decoder(code, qc, sigma, logp, **sp)
    n = frames_per_device * n_devices
    dyn = DynamicParams(num_iter_max=max_iter, num_iter_check_parity=k,
                        num_iter_first_check=first_check,
                        loading_factor=max(1, -(-n // dec.parallel_factor())),
                        target_errors=15)
    pool = _pool(dec, n)
    vals = np.empty((code.n_vars, n), np.float32)
    vals[np.asarray(dec.tables.vn_order)] = np.asarray(pool.values_sorted)
    syn = np.empty((code.n_checks, n), np.int8)
    syn[np.asarray(dec.tables.cn_order)] = np.asarray(pool.syn_sorted)
    ref = np.asarray(pool.ref_packed)
    dec.decode_sharded(dyn, n, vals, syn, mesh)  # compile
    res_m, st_m = dec.decode_sharded(dyn, n, vals, syn, mesh)
    dec.decode_presorted(dyn, n, pool.values_sorted, pool.syn_sorted)
    res_1, st_1 = dec.decode_presorted(dyn, n, pool.values_sorted,
                                       pool.syn_sorted)
    err_m = np.bitwise_count(res_m ^ ref).sum(axis=1)
    err_1 = np.bitwise_count(res_1 ^ ref).sum(axis=1)
    mbit = code.n_vars * n / 1048576.0
    out = {
        "devices": n_devices, "frames": n, "kernel": dec.kernel,
        "frames_with_errors_multi": int((err_m > 0).sum()),
        "frames_with_errors_one": int((err_1 > 0).sum()),
        "frames_bits_differ": int((res_m != res_1).any(axis=1).sum()),
        "frames_iters_differ": int((st_m.iterations
                                    != st_1.iterations).sum()),
        "max_iter_difference": int(np.abs(st_m.iterations.astype(int)
                                          - st_1.iterations).max()),
        "multi_mbps": mbit / st_m.elapsed_seconds,
        "one_mbps": mbit / st_1.elapsed_seconds,
    }
    log(f"multi: {json.dumps(out)}")
    assert out["frames_with_errors_multi"] == 0, out
    assert out["frames_with_errors_one"] == 0, out
    assert out["frames_bits_differ"] == 0, out
    assert out["max_iter_difference"] <= k, out
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-device sharded decode phase")
    args = ap.parse_args(argv)

    devs = phase_device()
    log(f"card: {card_info()}")
    from ldpc_decoder_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    t_all = time.perf_counter()
    from bench import P41_ALIST, get_code, get_random36_code, get_reg36_code

    p41, p41_qc = get_code()
    if args.multi:
        phase_multi(p41, p41_qc, P41["sigma"], 8, 4, 256, P41["k"],
                    P41["max_iter"], P41["first_check"])
    else:
        phase_numerics()
        phase_kernel_vs_oracle(p41, p41_qc, P41["sigma"], 8, P41["k"])
        _, dec, dyn, (pool, res) = phase_end_to_end(
            "p41", p41, p41_qc, P41["sigma"], 8, P41["frames"], P41["k"],
            P41["max_iter"], P41["first_check"])
        phase_host_fed(dec, dyn, pool, res)
        del dec, pool
        reg36, reg36_qc = get_reg36_code()
        phase_end_to_end("reg36_qc", reg36, reg36_qc, 0.87, 8, 512, 10, 120)
        phase_end_to_end("random36_general", get_random36_code(), None,
                         0.84, 8, 256, 10, 120, qc_autodetect=False)
        phase_cli(P41_ALIST, P41["sigma"], 6, 1, P41["max_iter"],
                  ("--check-period", "14"))
    log(f"total {time.perf_counter() - t_all:.1f}s")
    log(f"card: {card_info()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
