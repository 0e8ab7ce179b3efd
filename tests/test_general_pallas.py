"""The general (non-QC) path, ops/decode.py, through the decoder: any alist
decodes on XLA, and an explicit Pallas request for it is refused."""

import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_decoder_tpu.channels import BIAWGNChannel
from ldpc_decoder_tpu.codes.generate import make_regular_code
from ldpc_decoder_tpu.runtime.datagen import create_data
from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams


def test_decoder_pallas_decodes_below_threshold():
    """The general path decodes a random (3,6) code below threshold; an
    explicit Pallas request for a non-QC code raises."""
    code = make_regular_code(512, 3, 6, seed=23)
    ch = BIAWGNChannel(0.7)
    n = 8
    batch = create_data(code, ch, 0, n)
    dyn = DynamicParams(num_iter_max=80, num_iter_check_parity=10,
                        loading_factor=1, target_errors=15)
    dec = LDPCDecoder(
        code, ch,
        StaticParams(max_log_parallel_factor_user=3, kernel_impl="auto",
                     message_dtype="bfloat16", qc_autodetect=False),
    )
    assert dec.kernel == "xla"
    results, stats = dec.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(
        batch.ref_bits_packed() ^ np.asarray(results)
    ).sum()
    assert errors == 0
    with pytest.raises(ValueError, match="quasi-cyclic"):
        LDPCDecoder(code, ch, StaticParams(
            kernel_impl="pallas", pallas_interpret=True,
            qc_autodetect=False))


def test_bf16_pool_single_fill_presorted():
    """Forced non-pow2 lane count (StaticParams.parallel_factor_user), bf16
    LLR pool (lossless — the LLR state is bf16 anyway), single-fill pool
    (n == B exercises the identity init-gather skip), presorted
    decode_presorted entry."""
    code = make_regular_code(512, 3, 6, seed=29)
    ch = BIAWGNChannel(0.72)
    n = 24
    batch = create_data(code, ch, 0, n)
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5,
                        loading_factor=1, target_errors=15)
    dec = LDPCDecoder(
        code, ch,
        StaticParams(parallel_factor_user=n, kernel_impl="xla",
                     message_dtype="bfloat16", qc_autodetect=False),
    )
    vn = np.asarray(dec.cc.vn_order)
    cn = np.asarray(dec.cc.cn_order)
    vals = jnp.asarray(ch.llr_np(batch.values)[vn]).astype(jnp.bfloat16)
    syn = jnp.asarray(batch.syndromes[cn].astype(np.int8))
    results, stats = dec.decode_presorted(dyn, n, vals, syn,
                                          input_is_llr=True)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ results).sum()
    assert int(errors) == 0


def test_decoder_minsum_general_int8_decodes():
    """End-to-end: non-QC code through the decoder with
    algorithm='min-sum' + int8 messages. NMS alpha 0.8 on (3,6) at sigma
    0.7 has ~0.17 sigma of margin — must decode clean."""
    code = make_regular_code(512, 3, 6, seed=41)
    ch = BIAWGNChannel(0.7)
    n = 16
    batch = create_data(code, ch, 0, n)
    dyn = DynamicParams(num_iter_max=80, num_iter_check_parity=5,
                        loading_factor=2, target_errors=15)
    dec = LDPCDecoder(
        code, ch,
        StaticParams(max_log_parallel_factor_user=3, kernel_impl="xla",
                     algorithm="min-sum", minsum_alpha=0.8,
                     minsum_offset=0.0, message_dtype="int8",
                     qc_autodetect=False),
    )
    results, stats = dec.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ results).sum()
    assert int(errors) == 0
