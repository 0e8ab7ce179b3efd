"""Multi-process (multi-host) decoding via jax.distributed.

The reference is strictly single-process/single-GPU (SURVEY.md §2: no
distributed backend exists); scaling it means running N independent
binaries. Here the frame pool spans any number of hosts: frames never
cross devices, so multi-host decode is

1. ``jax.distributed.initialize`` (one controller per host/process);
2. each process generates ONLY its local devices' pool shards — the
   seekable ChaCha streams are keyed by absolute frame index
   (main.cpp:474-487 contract), so per-host generation needs no
   communication and any frame is reproducible anywhere;
3. the same ``shard_map`` decode as the single-process multi-chip path,
   over the *global* mesh: the only cross-host traffic is the psum'd
   remaining-frames scalar in the while_loop condition
   and a tiny allgather of report statistics at the end.

On CPU (tests/CI) the cross-process collectives use XLA's gloo backend;
on GPUs the same code rides NCCL.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, cpu_devices_per_process: int | None = None):
    """jax.distributed.initialize with an optional virtual-CPU backend.

    ``cpu_devices_per_process`` forces the CPU platform with that many
    virtual devices (the multi-host CI configuration); on accelerator
    hosts leave it None and let the runtime enumerate local devices.
    """
    import jax

    if cpu_devices_per_process is not None:
        jax.config.update("jax_num_cpu_devices", cpu_devices_per_process)
        jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_batch_mesh():
    """1-D 'batch' mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), axis_names=("batch",))


@dataclass
class MultiProcessStats:
    """Globally aggregated decode statistics (every process holds them)."""

    n_vecs: int
    min_iter: int
    max_iter: int
    avg_iter: float
    total_supersteps: int
    elapsed_seconds: float
    batch_size: int  # global lanes in flight
    bit_errors: int
    frames_with_errors: int
    frames_above_target: int
    max_frame_errors: int
    num_iter_check_parity: int = 1  # k: BP iterations per superstep

    @property
    def iter_time_per_vector(self) -> float:
        # total iterations = supersteps * k (reference formula,
        # ldpc_decoder_gpu.cu:628) — matches single-process DecodeStats
        denom = (self.total_supersteps * self.num_iter_check_parity
                 * self.batch_size)
        return self.elapsed_seconds / denom if denom else 0.0


def decode_multiprocess(
    decoder,
    dyn_params,
    n_vecs: int,
    start_index: int = 0,
    mesh=None,
    target_errors: int | None = None,
):
    """Full multi-process decode of ``n_vecs`` globally indexed frames.

    Every process calls this with identical arguments (SPMD). Device at
    mesh position g owns the contiguous frame range
    [g*n_local, (g+1)*n_local); the owning process generates that range
    locally (create_data), decodes via the global-mesh shard_map driver,
    counts its local errors against its own reference bits, and
    allgathers the scalar statistics.

    Returns (local_results, local_frame_ids, stats): packed decoded bits
    and global frame indices for THIS process's shard, plus globally
    aggregated MultiProcessStats.
    """
    import time

    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ldpc_decoder_tpu.ops.phi import pre_from_infinity_threshold
    from ldpc_decoder_tpu.runtime.datagen import create_data

    if mesh is None:
        mesh = global_batch_mesh()
    mesh_devs = list(mesh.devices.ravel())
    D = len(mesh_devs)
    n_local = -(-n_vecs // D)  # frames per device
    k = dyn_params.num_iter_check_parity
    max_iter = dyn_params.num_iter_max
    code = decoder.code
    vn_order = np.asarray(decoder.cc.vn_order)
    cn_order = np.asarray(decoder.cc.cn_order)

    # generate local shards; remember reference bits for error counting
    local_vals, local_syn, local_refs, local_ids = [], [], [], []
    for g, dev in enumerate(mesh_devs):
        if dev.process_index != jax.process_index():
            continue
        lo = start_index + g * n_local
        n_gen = max(0, min(n_vecs - g * n_local, n_local))
        vals = np.zeros((code.n_vars, n_local), np.float32)
        syn = np.zeros((code.n_checks, n_local), np.int8)
        # pad frames decode instantly: all-zero bits satisfy syndrome 0
        vals[: code.n_vars - code.n_erased_vars, :] = -1.0
        refs = np.zeros((code.n_vars, n_local), np.int8)
        if n_gen:
            batch = create_data(code, decoder.channel, lo, n_gen)
            vals[:, :n_gen] = batch.values
            syn[:, :n_gen] = batch.syndromes
            refs[:, :n_gen] = batch.ref_bits
        local_vals.append(jax.device_put(vals[vn_order], dev))
        local_syn.append(jax.device_put(syn[cn_order], dev))
        local_refs.append(refs)
        local_ids.append(np.arange(lo, lo + n_local))

    def global_pool(shards, n_rows, dtype):
        return jax.make_array_from_single_device_arrays(
            (n_rows, n_local * D),
            NamedSharding(mesh, P(None, "batch")),
            shards,
        )

    pool_values = global_pool(local_vals, code.n_vars, np.float32)
    pool_syn = global_pool(local_syn, code.n_checks, np.int8)

    phi_pre = pre_from_infinity_threshold(dyn_params.infinity_threshold)
    fn = decoder._mesh_decode_fn(k, max_iter, n_local, mesh, phi_pre)
    fn.lower(pool_values, pool_syn).compile()  # keep compile out of timing
    t0 = time.perf_counter()
    results_sh, iters_sh, supersteps_sh = fn(pool_values, pool_syn)
    jax.block_until_ready(results_sh)
    elapsed = time.perf_counter() - t0

    # local views: device g's rows [g*(n_local+1), (g+1)*(n_local+1))
    loc_res, loc_iters = [], []
    for shard in results_sh.addressable_shards:
        loc_res.append(np.asarray(shard.data)[:-1])  # drop sentinel row
    for shard in iters_sh.addressable_shards:
        loc_iters.append(np.asarray(shard.data)[:-1])
    supersteps = int(np.max(np.asarray(
        [np.asarray(s.data) for s in supersteps_sh.addressable_shards])))

    # local error counting vs locally generated reference bits
    te = (dyn_params.target_errors if target_errors is None
          else target_errors)
    n_words = decoder.n_words
    bit_errors = frames_err = frames_above = max_err = 0
    iter_min, iter_max, iter_sum, n_counted = 1 << 30, 0, 0, 0
    for refs, ids, res, iters in zip(local_refs, local_ids, loc_res,
                                     loc_iters):
        real = ids < start_index + n_vecs
        if not real.any():
            continue
        shifts = np.arange(32, dtype=np.uint32)
        pad = n_words * 32 - code.n_vars
        rb = np.concatenate(
            [refs, np.zeros((pad, refs.shape[1]), np.int8)], axis=0
        ).astype(np.uint32).reshape(n_words, 32, -1)
        ref_packed = (rb << shifts[None, :, None]).sum(
            axis=1, dtype=np.uint32).T
        errs = np.bitwise_count(ref_packed[real] ^ res[real]).sum(axis=1)
        bit_errors += int(errs.sum())
        frames_err += int((errs > 0).sum())
        frames_above += int((errs > te).sum())
        max_err = max(max_err, int(errs.max(initial=0)))
        it = iters[real]
        iter_min = min(iter_min, int(it.min(initial=1 << 30)))
        iter_max = max(iter_max, int(it.max(initial=0)))
        iter_sum += int(it.sum())
        n_counted += int(real.sum())

    # allgather scalar stats (the only cross-host reporting traffic)
    local_stats = np.array(
        [bit_errors, frames_err, frames_above, max_err,
         iter_min, iter_max, iter_sum, n_counted], np.int64)
    gathered = np.asarray(multihost_utils.process_allgather(local_stats))
    g = gathered.reshape(-1, 8)
    stats = MultiProcessStats(
        n_vecs=n_vecs,
        min_iter=int(g[:, 4].min()),
        max_iter=int(g[:, 5].max()),
        avg_iter=float(g[:, 6].sum()) / max(int(g[:, 7].sum()), 1),
        total_supersteps=supersteps,
        elapsed_seconds=elapsed,
        batch_size=decoder.parallel_factor() * D,
        bit_errors=int(g[:, 0].sum()),
        frames_with_errors=int(g[:, 1].sum()),
        frames_above_target=int(g[:, 2].sum()),
        max_frame_errors=int(g[:, 3].max()),
        num_iter_check_parity=k,
    )
    return loc_res, local_ids, stats
