"""Fully on-device test-vector generation.

The reference generates data on the CPU and ships it over PCIe
(main.cpp:450-538 + transfer_vectors). Here the whole pipeline can run on
the device instead, with nothing to transfer: ChaCha8 reference bits ->
channel noise -> syndromes, all seeded by absolute frame indices
(reproducible, seekable; see rng/chacha_jax.py for the
stream-compatibility contract).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ldpc_decoder_tpu.channels.base import Channel
from ldpc_decoder_tpu.channels.biawgn import BIAWGNChannel
from ldpc_decoder_tpu.channels.bsc import BSCChannel
from ldpc_decoder_tpu.codes.compiled import CompiledCode
from ldpc_decoder_tpu.ops import decode as ops
from ldpc_decoder_tpu.rng import chacha_jax as cj


class DevicePool(NamedTuple):
    """A decode-ready pool of frames, resident on device."""

    values_sorted: jnp.ndarray   # [n_vars, N] f32, sorted vn order
    syn_sorted: jnp.ndarray      # [n_checks, N] int8, sorted cn order
    ref_packed: jnp.ndarray      # [N, n_words] uint32, natural order


def _pack_rows(bits_nat: jnp.ndarray, n_words: int) -> jnp.ndarray:
    bits = bits_nat.astype(jnp.uint32)
    n_vars, b = bits.shape
    pad = n_words * 32 - n_vars
    if pad:
        bits = jnp.concatenate([bits, jnp.zeros((pad, b), jnp.uint32)])
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, :, None]
    return jnp.sum(
        bits.reshape(n_words, 32, b) << shifts, axis=1, dtype=jnp.uint32
    ).T


@partial(
    jax.jit,
    static_argnames=("n_vars", "n_frames", "channel_type", "noise",
                     "n_erased"),
)
def _make_pool(
    tables: ops.DecodeTables,
    vn_order: jnp.ndarray,
    start_index: jnp.ndarray,
    n_vars: int,
    n_frames: int,
    channel_type: str,
    noise: float,
    n_erased: int,
):
    ref_bits = cj.reference_bits_device(start_index, n_vars, n_frames)
    if channel_type == "bsc":
        values = cj.bsc_values_device(
            ref_bits, start_index, n_vars, n_frames, noise
        )
    elif channel_type == "awgn":
        values = cj.awgn_values_device(
            ref_bits, start_index, n_vars, n_frames, noise
        )
    elif channel_type == "erasure":
        values = cj.erasure_values_device(
            ref_bits, start_index, n_vars, n_frames, noise
        )
    else:
        raise ValueError(channel_type)
    if n_erased:
        values = values.at[n_vars - n_erased :].set(0.0)
    bits_sorted = jnp.take(ref_bits, vn_order, axis=0)
    from ldpc_decoder_tpu.ops.qc_decode import (
        QCDecodeTables,
        syndrome_from_bits_qc,
    )

    if isinstance(tables, QCDecodeTables):
        syn_sorted = syndrome_from_bits_qc(bits_sorted, tables)
    else:
        syn_sorted = ops.syndrome_from_bits(bits_sorted, tables)
    values_sorted = jnp.take(values, vn_order, axis=0)
    n_words = (n_vars + 31) // 32
    ref_packed = _pack_rows(ref_bits, n_words)
    return values_sorted, syn_sorted, ref_packed


def create_pool_device(
    cc: CompiledCode,
    tables: ops.DecodeTables,
    channel: Channel,
    start_index: int,
    n_frames: int,
    batch_index: int = 0,
    chunk_frames: int = 64,
) -> DevicePool:
    """Generate a frame pool on device. n_frames must be a multiple of 32.

    Generation is chunked along the frame axis so the uint32 keystream
    temporaries (2 words per AWGN sample) never exceed a few hundred MB.
    Chunking is free w.r.t. reproducibility: seeds depend only on absolute
    frame indices.
    """
    if n_frames % 32:
        raise ValueError("on-device generation requires n_frames % 32 == 0")
    if isinstance(channel, BSCChannel):
        ctype, noise = "bsc", channel.p
    elif isinstance(channel, BIAWGNChannel):
        ctype, noise = "awgn", channel.sigma
    elif getattr(channel, "channel_type", None) == "erasure":
        ctype, noise = "erasure", channel.epsilon
    else:
        raise ValueError(f"unsupported channel {channel!r}")
    base = start_index + batch_index * n_frames
    chunk = max(32, (min(chunk_frames, n_frames) // 32) * 32)
    vals, syns, refs = [], [], []
    for lo in range(0, n_frames, chunk):
        c = min(chunk, n_frames - lo)
        v, s, r = _make_pool(
            tables,
            tables.vn_order,
            jnp.asarray(base + lo, jnp.uint32),
            cc.code.n_vars,
            c,
            ctype,
            noise,
            cc.code.n_erased_vars,
        )
        vals.append(v)
        syns.append(s)
        refs.append(r)
    if len(vals) == 1:
        return DevicePool(vals[0], syns[0], refs[0])
    return DevicePool(
        values_sorted=jnp.concatenate(vals, axis=1),
        syn_sorted=jnp.concatenate(syns, axis=1),
        ref_packed=jnp.concatenate(refs, axis=0),
    )


@jax.jit
def count_bit_errors(results: jnp.ndarray, ref_packed: jnp.ndarray):
    """Per-frame XOR-popcount of packed decoded vs reference bits
    (main.cpp:416-431 on device). -> [N] int32."""
    return jnp.sum(
        jax.lax.population_count(results ^ ref_packed),
        axis=1,
        dtype=jnp.int32,
    )
