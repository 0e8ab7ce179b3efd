"""On-device ChaCha8 PRNG and channel simulation (jnp/XLA).

The device twin of :mod:`ldpc_decoder_tpu.rng.chacha_np`: the same
(seed, word-index) -> uint32 pure function, evaluated as vectorized uint32
arithmetic on the device. This makes the whole data-generation pipeline —
reference bits, channel noise, syndromes — run on device with zero host
transfers, while staying reproducible from absolute frame indices exactly
like the reference (main.cpp:474-481).

Stream compatibility:

- reference bits and BSC flips are *bit-exact* with the reference's
  draws (same ChaCha8 streams, same unit() semantics);
- AWGN gaussians use the same per-frame streams but a rejection-free
  Box–Muller (sqrt(-2 ln u1)·cos(2π u2) on consecutive unit pairs) instead
  of the reference's polar loop (rng.h:49-70), because data-dependent
  rejection cannot run shape-statically. Statistics are identical; the
  CPU path (chacha_np) remains the stream-exact oracle for golden tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_decoder_tpu.rng.chacha_np import BLOCKS_PER_REFILL

_CONST = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(x, n):
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _qr(s, a, b, c, d):
    s[a] = s[a] + s[b]
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = s[c] + s[d]
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = s[a] + s[b]
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = s[c] + s[d]
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha8_blocks(
    key01: jnp.ndarray,  # [2, n] uint32 (key words 0..1; 2..7 are zero)
    counters: jnp.ndarray,  # [n] uint32 (block counter within refill, < 24)
    nonces: jnp.ndarray,  # [n] uint32 (refill index)
) -> jnp.ndarray:
    """ChaCha8 keystream blocks, vectorized over the last axis -> [16, n].

    Matches prng_chacha.cpp:39-67: key = 64-bit seed in words 0..1, counter
    restarts per 1536-byte refill, nonce = refill index (< 2^32 in practice).
    """
    n = counters.shape[0]
    z = jnp.zeros((n,), jnp.uint32)
    init = [jnp.full((n,), c, jnp.uint32) for c in _CONST]
    init += [key01[0], key01[1], z, z, z, z, z, z]
    init += [counters.astype(jnp.uint32), z, nonces.astype(jnp.uint32), z]
    s = list(init)
    for _ in range(4):  # 8 rounds = 4 double rounds
        _qr(s, 0, 4, 8, 12)
        _qr(s, 1, 5, 9, 13)
        _qr(s, 2, 6, 10, 14)
        _qr(s, 3, 7, 11, 15)
        _qr(s, 0, 5, 10, 15)
        _qr(s, 1, 6, 11, 12)
        _qr(s, 2, 7, 8, 13)
        _qr(s, 3, 4, 9, 14)
    return jnp.stack([a + b for a, b in zip(s, init)])


def stream_words_2d(
    seeds: jnp.ndarray,  # [m] uint64-as-two-uint32? -> pass [2, m] uint32
    n_words: int,
) -> jnp.ndarray:
    """Words 0..n_words of the buffered stream for each seed -> [m, n_words].

    ``seeds`` is given split as [2, m] uint32 (lo, hi) to avoid uint64 on
    the device. n_words is padded up to a whole number of blocks internally.
    """
    m = seeds.shape[1]
    n_blocks = -(-n_words // 16)
    blk = jnp.arange(n_blocks, dtype=jnp.uint32)
    nonces = blk // BLOCKS_PER_REFILL
    counters = blk % BLOCKS_PER_REFILL
    # vectorize over (seed, block): [2, m*n_blocks]
    key01 = jnp.repeat(seeds, n_blocks, axis=1)
    counters = jnp.tile(counters, m)
    nonces = jnp.tile(nonces, m)
    words = chacha8_blocks(key01, counters, nonces)  # [16, m*n_blocks]
    words = words.T.reshape(m, n_blocks * 16)
    return words[:, :n_words]


def units_from_words(words: jnp.ndarray) -> jnp.ndarray:
    """rng.h:38-42: (float32(u32) + 0.5) * 2^-32."""
    return (words.astype(jnp.float32) + jnp.float32(0.5)) * jnp.float32(
        2.0**-32
    )


@partial(jax.jit, static_argnames=("n_vars", "n_frames"))
def reference_bits_device(
    start_index: jnp.ndarray, n_vars: int, n_frames: int
) -> jnp.ndarray:
    """[n_vars, n_frames] int8 reference bits, bit-exact with
    datagen.generate_reference_bits (main.cpp:478-487).

    n_frames must be a multiple of 32.
    """
    assert n_frames % 32 == 0
    n_groups = n_frames // 32
    seeds_lo = (
        start_index.astype(jnp.uint32)
        + 32 * jnp.arange(n_groups, dtype=jnp.uint32)
    )
    seeds = jnp.stack([seeds_lo, jnp.zeros_like(seeds_lo)])
    words = stream_words_2d(seeds, n_vars)  # [n_groups, n_vars]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    # [n_groups, n_vars, 32] -> [n_vars, n_groups*32]
    return (
        bits.transpose(1, 0, 2).reshape(n_vars, n_frames).astype(jnp.int8)
    )


def _noise_seeds(start_index: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """[2, n_frames] uint32 seeds (start+v) | 2^32 (main.cpp:522)."""
    lo = start_index.astype(jnp.uint32) + jnp.arange(
        n_frames, dtype=jnp.uint32
    )
    hi = jnp.ones((n_frames,), jnp.uint32)  # the 2^32 flag bit
    return jnp.stack([lo, hi])


@partial(jax.jit, static_argnames=("n_vars", "n_frames", "p"))
def bsc_values_device(
    ref_bits: jnp.ndarray,  # [n_vars, n_frames] int8
    start_index: jnp.ndarray,
    n_vars: int,
    n_frames: int,
    p: float,
) -> jnp.ndarray:
    """±1 modulated BSC channel values, draw-exact with the reference
    (one unit per transmitted bit, flip if < p; channel.cpp:34-38)."""
    seeds = _noise_seeds(start_index, n_frames)
    words = stream_words_2d(seeds, n_vars)  # [n_frames, n_vars]
    flips = units_from_words(words).T < jnp.float32(p)  # [n_vars, n_frames]
    tx = jnp.where(ref_bits > 0, 1.0, -1.0).astype(jnp.float32)
    return jnp.where(flips, -tx, tx)


@partial(jax.jit, static_argnames=("n_vars", "n_frames", "epsilon"))
def erasure_values_device(
    ref_bits: jnp.ndarray,  # [n_vars, n_frames] int8
    start_index: jnp.ndarray,
    n_vars: int,
    n_frames: int,
    epsilon: float,
) -> jnp.ndarray:
    """BEC channel values: 0 = erased, else ±1. Same one-unit-per-bit draw
    pattern as the BSC (channels/erasure.py add_noise_np)."""
    seeds = _noise_seeds(start_index, n_frames)
    words = stream_words_2d(seeds, n_vars)
    erased = units_from_words(words).T < jnp.float32(epsilon)
    tx = jnp.where(ref_bits > 0, 1.0, -1.0).astype(jnp.float32)
    return jnp.where(erased, 0.0, tx)


@partial(jax.jit, static_argnames=("n_vars", "n_frames", "sigma"))
def awgn_values_device(
    ref_bits: jnp.ndarray,
    start_index: jnp.ndarray,
    n_vars: int,
    n_frames: int,
    sigma: float,
) -> jnp.ndarray:
    """±1 + σ·N(0,1) channel values. Same per-frame streams as the
    reference; rejection-free Box–Muller (see module docstring)."""
    seeds = _noise_seeds(start_index, n_frames)
    words = stream_words_2d(seeds, 2 * n_vars)  # [n_frames, 2*n_vars]
    u = units_from_words(words)
    u1 = u[:, 0::2].T  # [n_vars, n_frames]
    u2 = u[:, 1::2].T
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    g = r * jnp.cos(2.0 * jnp.float32(np.pi) * u2)
    tx = jnp.where(ref_bits > 0, 1.0, -1.0).astype(jnp.float32)
    return tx + jnp.float32(sigma) * g
