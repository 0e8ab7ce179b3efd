"""ldpc_decoder_tpu — an LDPC soft-decoding framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the GPU decoder
``kunzjacq/ldpc_decoder`` (C++/CUDA/OpenCL): syndrome-based flood (belief
propagation) decoding of large irregular LDPC codes with on-the-fly replacement
of converged frames, BSC/AWGN channel simulation driven by a seekable ChaCha8
PRNG, and a self-testing harness reporting BER/FER/iteration/throughput
statistics.

Design notes (vs the reference, see SURVEY.md):

- Frames occupy the last (contiguous) axis of every device array, edges/bits
  the rows — the reference's frame-interleaved SoA layout
  (reference: flood.cu:57,133 ``v + num_vecs * i``).
- The Tanner graph is compiled once into degree-sorted static index tables so
  that both belief-propagation half-passes are dense reshape+reduce over small
  degree buckets plus exactly two row-gather permutations per iteration
  (reference: CSR tables built at ldpc_code.cpp:119-151 walked by per-thread
  running pointers, flood.cu:127-156).
- The reference's host-driven permute/retire/refill scheduler
  (ldpc_decoder_gpu.cu:464-611) collapses into an on-device convergence bitmap
  and masked lane refill from a device-resident frame pool.
"""

__version__ = "0.1.0"

from ldpc_decoder_tpu.codes.code import LDPCCode, compute_syndrome, rate
from ldpc_decoder_tpu.codes.alist import parse_alist, write_alist
from ldpc_decoder_tpu.channels.base import Channel
from ldpc_decoder_tpu.channels.bsc import BSCChannel
from ldpc_decoder_tpu.channels.biawgn import BIAWGNChannel

__all__ = [
    "LDPCCode",
    "compute_syndrome",
    "rate",
    "parse_alist",
    "write_alist",
    "Channel",
    "BSCChannel",
    "BIAWGNChannel",
    "__version__",
]
