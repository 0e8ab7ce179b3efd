"""Irregular-base (several degree groups) Pallas Triton kernels vs the
XLA QC oracle, in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_decoder_tpu.channels import BIAWGNChannel
from ldpc_decoder_tpu.codes.protographs import ar4ja_base, ru_irregular_base
from ldpc_decoder_tpu.codes.qc import make_qc_code
from ldpc_decoder_tpu.runtime.datagen import create_data
from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams


def _decoders(code, s, ch, **kw):
    return (
        LDPCDecoder(code, ch, StaticParams(
            max_log_parallel_factor_user=3, kernel_impl="pallas",
            pallas_interpret=True, **kw),
            qc=s),
        LDPCDecoder(code, ch, StaticParams(
            max_log_parallel_factor_user=3, kernel_impl="xla", **kw),
            qc=s),
    )


def _check_equivalence(code, s, ch, n=8, ks=(1, 3)):
    dec_pl, dec_xla = _decoders(code, s, ch)
    assert dec_pl.kernel == "triton"
    batch = create_data(code, ch, 0, n)
    t = dec_pl.tables
    llr2d = jnp.asarray(
        ch.llr_np(batch.values)[np.asarray(t.vn_order)][:, :n])
    syn2d = jnp.asarray(batch.syndromes[np.asarray(t.cn_order)][:, :n])
    m_pl = dec_pl._init_messages(llr2d, t)
    m_xla = dec_xla._init_messages(llr2d, dec_xla.tables)
    for k in ks:
        _, bits_pl, viol_pl = dec_pl._run_iterations(
            m_pl, llr2d, syn2d, t, k)
        _, bits_xla, viol_xla = dec_xla._run_iterations(
            m_xla, llr2d, syn2d, dec_xla.tables, k)
        np.testing.assert_array_equal(
            np.asarray(bits_pl), np.asarray(bits_xla))
        np.testing.assert_array_equal(
            np.asarray(viol_pl), np.asarray(viol_xla))


def test_ru_irregular_grouped_matches_xla():
    base, _ = ru_irregular_base(3, seed=4)  # 9x18 base, degrees {2,3,8}/{6,7}
    code, s = make_qc_code(base, Z=256, seed=5)
    _check_equivalence(code, s, BIAWGNChannel(0.8))


def test_ar4ja_grouped_matches_xla():
    base, _ = ar4ja_base()
    code, s = make_qc_code(base, Z=512, seed=6)
    _check_equivalence(code, s, BIAWGNChannel(0.8))


def test_grouped_seam_mode_matches_xla():
    base, _ = ru_irregular_base(3, seed=4)
    code, s = make_qc_code(base, Z=1024, seed=7, coarse=256, fine_mod=4)
    ch = BIAWGNChannel(0.8)
    _check_equivalence(code, s, ch)


def test_grouped_end_to_end_decode():
    base, _ = ru_irregular_base(3, seed=4)
    code, s = make_qc_code(base, Z=512, seed=8)
    ch = BIAWGNChannel(0.75)
    dec, _ = _decoders(code, s, ch)
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5,
                        loading_factor=2)
    n = dec.parallel_factor() * 2
    batch = create_data(code, ch, 0, n)
    res, _ = dec.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ res).sum()
    assert errors == 0


def test_grouped_minsum_end_to_end():
    base, _ = ru_irregular_base(3, seed=4)
    code, s = make_qc_code(base, Z=512, seed=9)
    ch = BIAWGNChannel(0.65)
    dec, _ = _decoders(code, s, ch, algorithm="min-sum",
                       message_dtype="bfloat16")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5,
                        loading_factor=1)
    n = dec.parallel_factor()
    batch = create_data(code, ch, 0, n)
    res, _ = dec.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ res).sum()
    assert errors == 0


@pytest.mark.parametrize("alpha", [0.8125, ((6, 0.875), (7, 0.8125), (0, 1.0))])
def test_grouped_normalized_minsum_matches_xla(alpha):
    """Normalized min-sum (uniform and degree-matched α): Pallas grouped
    kernels stay bit-identical to the XLA oracle."""
    base, _ = ru_irregular_base(3, seed=4)
    code, s = make_qc_code(base, Z=256, seed=5)
    ch = BIAWGNChannel(0.7)
    dec_pl, dec_xla = _decoders(code, s, ch, algorithm="min-sum",
                                minsum_offset=0.0, minsum_alpha=alpha)
    n = 8
    batch = create_data(code, ch, 0, n)
    t = dec_pl.tables
    llr2d = jnp.asarray(
        ch.llr_np(batch.values)[np.asarray(t.vn_order)][:, :n])
    syn2d = jnp.asarray(batch.syndromes[np.asarray(t.cn_order)][:, :n])
    m_pl = dec_pl._init_messages(llr2d, t)
    m_xla = dec_xla._init_messages(llr2d, dec_xla.tables)
    for k in (1, 3):
        _, bits_pl, viol_pl = dec_pl._run_iterations(m_pl, llr2d, syn2d, t, k)
        _, bits_xla, viol_xla = dec_xla._run_iterations(
            m_xla, llr2d, syn2d, dec_xla.tables, k)
        np.testing.assert_array_equal(
            np.asarray(bits_pl), np.asarray(bits_xla))
        np.testing.assert_array_equal(
            np.asarray(viol_pl), np.asarray(viol_xla))
    # alpha != 1 must actually change the result vs plain min-sum
    dec_ms, _ = _decoders(code, s, ch, algorithm="min-sum",
                          minsum_offset=0.0)
    m_ms = dec_ms._init_messages(llr2d, dec_ms.tables)
    msgs_a, _, _ = dec_pl._run_iterations(m_pl, llr2d, syn2d, t, 2)
    msgs_1, _, _ = dec_ms._run_iterations(m_ms, llr2d, syn2d,
                                          dec_ms.tables, 2)
    assert not np.array_equal(np.asarray(msgs_a), np.asarray(msgs_1))


def test_grouped_normalized_minsum_end_to_end():
    base, _ = ru_irregular_base(3, seed=4)
    code, s = make_qc_code(base, Z=512, seed=9)
    ch = BIAWGNChannel(0.65)
    dec, _ = _decoders(code, s, ch, algorithm="min-sum",
                       message_dtype="bfloat16", minsum_offset=0.0,
                       minsum_alpha=0.8125)
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5,
                        loading_factor=1)
    n = dec.parallel_factor()
    batch = create_data(code, ch, 0, n)
    res, _ = dec.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ res).sum()
    assert errors == 0


def test_ar4ja_punctured_end_to_end():
    """AR4JA with its punctured column: erased variables get LLR 0 and are
    still recovered (the reference's #e= machinery, main.cpp:529-530)."""
    from ldpc_decoder_tpu.codes.protographs import make_protograph_code
    from ldpc_decoder_tpu.codes.code import rate

    base, punct = ar4ja_base()
    code, s = make_protograph_code(base, punct, Z=512, seed=11)
    assert code.n_erased_vars == 512
    assert abs(rate(code) - 0.5) < 1e-9
    ch = BIAWGNChannel(0.7)
    dec, _ = _decoders(code, s, ch)
    dyn = DynamicParams(num_iter_max=80, num_iter_check_parity=5,
                        loading_factor=1)
    n = dec.parallel_factor()
    batch = create_data(code, ch, 0, n)
    # erased tail carries no channel value
    assert (batch.values[-512:] == 0).all()
    res, _ = dec.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ res).sum()
    assert errors == 0


def test_p41_base_grouped_matches_xla():
    """The flagship p41 protograph's pre-lifted base (with DEGREE-1
    columns, whose VN launches are skipped on non-emit iterations) stays
    bit-identical to the XLA oracle across supersteps."""
    from ldpc_decoder_tpu.codes.protographs import P41_BASE, prelift_base

    big = prelift_base(P41_BASE[:, [0, 1, 2, 3, 4, 5, 6]], m=4, seed=0)
    code, s = make_qc_code(big, Z=128, seed=6, coarse=32, fine_mod=8,
                           min_girth=4)
    ch = BIAWGNChannel(0.8)
    _check_equivalence(code, s, ch, ks=(1, 4))


def test_grouped_fresh_lane_reset_matches_xla():
    """The lane-reset refill path (run_iterations ``fresh``): flagged
    lanes carry a STALE message state and must be reset in-kernel to the
    init values on the first iteration — bit-identical between the
    grouped Pallas kernels and the XLA oracle, and equal to decoding the
    fresh lane from a true init state."""
    from ldpc_decoder_tpu.codes.protographs import P41_BASE, prelift_base

    big = prelift_base(P41_BASE, m=4, seed=0)
    code, s = make_qc_code(big, Z=128, seed=6, coarse=32, fine_mod=8,
                           min_girth=4)
    ch = BIAWGNChannel(0.8)
    dec_pl, dec_xla = _decoders(code, s, ch)
    n = 8
    batch = create_data(code, ch, 0, n)
    t = dec_pl.tables
    llr2d = jnp.asarray(
        ch.llr_np(batch.values)[np.asarray(t.vn_order)][:, :n])
    syn2d = jnp.asarray(batch.syndromes[np.asarray(t.cn_order)][:, :n])
    rng = np.random.default_rng(3)
    fresh = jnp.asarray((rng.random(n) < 0.5).astype(np.int8))

    # stale state: init for a DIFFERENT llr (a retired frame's state)
    m_pl = dec_pl._init_messages(-2.0 * llr2d + 1.0, t)
    m_xla = dec_xla._init_messages(-2.0 * llr2d + 1.0, dec_xla.tables)
    for k in (1, 3):
        _, bits_pl, viol_pl = dec_pl._run_iterations(
            m_pl, llr2d, syn2d, t, k, fresh=fresh)
        _, bits_xla, viol_xla = dec_xla._run_iterations(
            m_xla, llr2d, syn2d, dec_xla.tables, k, fresh=fresh)
        np.testing.assert_array_equal(
            np.asarray(bits_pl), np.asarray(bits_xla))
        np.testing.assert_array_equal(
            np.asarray(viol_pl), np.asarray(viol_xla))

    # a fully-fresh lane after k iterations == a true-init lane after
    # k-1 iterations (the reset lane's first iteration is the reset)
    all_fresh = jnp.ones(n, jnp.int8)
    _, bits_a, _ = dec_pl._run_iterations(
        m_pl, llr2d, syn2d, t, 3, fresh=all_fresh)
    m_true = dec_pl._init_messages(llr2d, t)
    _, bits_b, _ = dec_pl._run_iterations(m_true, llr2d, syn2d, t, 2)
    np.testing.assert_array_equal(np.asarray(bits_a), np.asarray(bits_b))


def test_int8_minsum_matches_xla():
    """int8 fixed-point min-sum: Pallas grouped kernels bit-identical to
    the XLA oracle (hard decisions + parity flags), LLR state in the
    decoder's bf16 storage dtype as _init_state provides it."""
    base, _ = ru_irregular_base(3, seed=4)
    code, s = make_qc_code(base, Z=256, seed=5)
    ch = BIAWGNChannel(0.65)
    dec_pl, dec_xla = _decoders(code, s, ch, algorithm="min-sum",
                                message_dtype="int8", minsum_offset=0.4,
                                minsum_alpha=0.95)
    n = 8
    batch = create_data(code, ch, 0, n)
    t = dec_pl.tables
    llr2d = jnp.asarray(
        ch.llr_np(batch.values)[np.asarray(t.vn_order)][:, :n]
    ).astype(dec_pl._llr_dtype)
    syn2d = jnp.asarray(batch.syndromes[np.asarray(t.cn_order)][:, :n])
    m_pl = dec_pl._init_messages(llr2d, t, dtype=jnp.int8)
    m_xla = dec_xla._init_messages(llr2d, dec_xla.tables, dtype=jnp.int8)
    assert m_pl.dtype == jnp.int8 and m_xla.dtype == jnp.int8
    for k in (1, 3):
        _, bits_pl, viol_pl = dec_pl._run_iterations(m_pl, llr2d, syn2d, t, k)
        _, bits_xla, viol_xla = dec_xla._run_iterations(
            m_xla, llr2d, syn2d, dec_xla.tables, k)
        np.testing.assert_array_equal(
            np.asarray(bits_pl), np.asarray(bits_xla))
        np.testing.assert_array_equal(
            np.asarray(viol_pl), np.asarray(viol_xla))


def test_int8_minsum_end_to_end():
    """int8 offset-min-sum decodes clean through the full runtime
    (retire/refill, lane-reset fresh path) on both kernel impls."""
    base, _ = ru_irregular_base(3, seed=4)
    code, s = make_qc_code(base, Z=512, seed=9)
    ch = BIAWGNChannel(0.65)
    dec, _ = _decoders(code, s, ch, algorithm="min-sum",
                       message_dtype="int8", minsum_offset=0.4,
                       minsum_alpha=0.95)
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5,
                        loading_factor=2)
    n = dec.parallel_factor() * 2
    batch = create_data(code, ch, 0, n)
    res, _ = dec.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ res).sum()
    assert errors == 0


def test_int8_requires_minsum():
    base, _ = ru_irregular_base(3, seed=4)
    code, s = make_qc_code(base, Z=256, seed=5)
    with pytest.raises(ValueError, match="min-sum"):
        StaticParams(message_dtype="int8")
    with pytest.raises(ValueError, match="power of two"):
        StaticParams(message_dtype="int8", algorithm="min-sum",
                     minsum_qscale=3.0)
