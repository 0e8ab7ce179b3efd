"""Channel model interface.

Mirrors the reference's ``noisy_channel`` surface (h/channel.h:18-32):
noise addition for simulation, channel-value -> LLR conversion, Shannon
capacity, and a description string. LLR sign convention throughout the
framework: **LLR > 0 <=> bit = 1** (h/common.h:51-59); modulation is
bit 1 -> +1, bit 0 -> -1 (``bool_to_llr``, h/common.h:56-59).

Noise addition exists in two flavours:

- ``add_noise_np``: numpy, consuming a seekable PRNG stream in exactly the
  reference's draw order (channel.cpp:29-37, 60-68) — used for
  reference-stream-compatible data generation and golden tests.
- ``llr_from_channel``: the jittable device-side conversion of raw channel
  values to decoder-input LLRs (the analog of the llr_bsc/llr_biawgn
  kernels, flood.cu:47-75).
"""

from __future__ import annotations

import abc

import jax.numpy as jnp
import numpy as np


class Channel(abc.ABC):
    """A binary-input memoryless noisy channel."""

    #: CLI index (main.cpp:228-246): 0 = bsc, 1 = awgn
    channel_type: str

    @abc.abstractmethod
    def add_noise_np(self, prng, values: np.ndarray) -> np.ndarray:
        """Apply noise to ±1 modulated values, consuming ``prng`` draws in
        the reference's per-sample order. ``values`` is 1-D float32."""

    @abc.abstractmethod
    def llr_from_channel(self, values: jnp.ndarray) -> jnp.ndarray:
        """Convert raw channel output values to LLRs (jittable)."""

    @abc.abstractmethod
    def llr_np(self, values: np.ndarray) -> np.ndarray:
        """Numpy twin of :meth:`llr_from_channel` (channel.cpp:18-22,50-53)."""

    @abc.abstractmethod
    def capacity(self) -> float:
        """Shannon capacity in bits/symbol."""

    @abc.abstractmethod
    def description(self) -> str:
        ...
