"""Fused Pallas Triton QC kernels vs the XLA QC path (interpret mode on
CPU, where both evaluate through XLA:CPU and agree bit for bit)."""

import numpy as np
import pytest

from ldpc_decoder_tpu.channels import BIAWGNChannel
from ldpc_decoder_tpu.codes.qc import make_qc_code
from ldpc_decoder_tpu.runtime.datagen import create_data
from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams

BASE_36 = np.ones((3, 6), dtype=np.int8)


def _decoders(code, s, ch, dtype="float32"):
    sp_pl = StaticParams(max_log_parallel_factor_user=3,
                         kernel_impl="pallas", pallas_interpret=True,
                         message_dtype=dtype)
    sp_xla = StaticParams(max_log_parallel_factor_user=3,
                          kernel_impl="xla", message_dtype=dtype)
    return (
        LDPCDecoder(code, ch, sp_pl, qc=s),
        LDPCDecoder(code, ch, sp_xla, qc=s),
    )


def test_pallas_tables_built():
    from ldpc_decoder_tpu.ops.qc_triton import tile_config

    code, s = make_qc_code(BASE_36, Z=64, seed=1)
    ch = BIAWGNChannel(0.8)
    dec, dec_xla = _decoders(code, s, ch)
    assert dec.kernel == "triton" and dec_xla.kernel == "xla"
    t = dec.tables
    assert [g.degree for g in t.row_groups] == [6]
    assert [g.degree for g in t.col_groups] == [3]
    T, LB = tile_config(6, t.Z, dec.parallel_factor())
    assert t.Z % T == 0 and dec.parallel_factor() % LB == 0


def test_pallas_matches_xla_run_iterations():
    import jax.numpy as jnp

    code, s = make_qc_code(BASE_36, Z=64, seed=2)
    ch = BIAWGNChannel(0.8)
    dec_pl, dec_xla = _decoders(code, s, ch)
    n = 8
    batch = create_data(code, ch, 0, n)
    vn_order = np.asarray(dec_pl.tables.vn_order)
    cn_order = np.asarray(dec_pl.tables.cn_order)
    llr2d = jnp.asarray(ch.llr_np(batch.values)[vn_order][:, :n])
    syn2d = jnp.asarray(batch.syndromes[cn_order][:, :n])

    m_pl = dec_pl._init_messages(llr2d, dec_pl.tables)
    m_xla = dec_xla._init_messages(llr2d, dec_xla.tables)
    for k in (1, 3):
        m_pl2, bits_pl, viol_pl = dec_pl._run_iterations(
            m_pl, llr2d, syn2d, dec_pl.tables, k
        )
        m_xla2, bits_xla, viol_xla = dec_xla._run_iterations(
            m_xla, llr2d, syn2d, dec_xla.tables, k
        )
        np.testing.assert_array_equal(
            np.asarray(bits_pl), np.asarray(bits_xla)
        )
        np.testing.assert_array_equal(
            np.asarray(viol_pl), np.asarray(viol_xla)
        )


def test_pallas_decoder_end_to_end_matches():
    code, s = make_qc_code(BASE_36, Z=128, seed=3)
    ch = BIAWGNChannel(0.72)
    dec_pl, dec_xla = _decoders(code, s, ch)
    dyn = DynamicParams(num_iter_max=40, num_iter_check_parity=5,
                        loading_factor=2)
    n = dec_pl.parallel_factor() * dyn.loading_factor
    batch = create_data(code, ch, 0, n)
    res_pl, st_pl = dec_pl.decode(dyn, n, batch.values, batch.syndromes)
    res_xla, st_xla = dec_xla.decode(dyn, n, batch.values, batch.syndromes)
    np.testing.assert_array_equal(res_pl, res_xla)
    np.testing.assert_array_equal(st_pl.iterations, st_xla.iterations)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ res_pl).sum()
    assert errors == 0


def test_pallas_bf16_decodes():
    code, s = make_qc_code(BASE_36, Z=128, seed=4)
    ch = BIAWGNChannel(0.7)
    dec_pl, _ = _decoders(code, s, ch, dtype="bfloat16")
    dyn = DynamicParams(num_iter_max=40, num_iter_check_parity=5,
                        loading_factor=1)
    n = dec_pl.parallel_factor()
    batch = create_data(code, ch, 0, n)
    res, _ = dec_pl.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ res).sum()
    assert errors == 0


def test_device_pool_with_pallas_tables():
    from ldpc_decoder_tpu.runtime.datagen_device import create_pool_device

    code, s = make_qc_code(BASE_36, Z=64, seed=5)
    ch = BIAWGNChannel(0.8)
    dec, _ = _decoders(code, s, ch)
    pool = create_pool_device(dec.cc, dec.tables, ch, 0, 32)
    batch = create_data(code, ch, 0, 32)
    np.testing.assert_array_equal(
        np.asarray(pool.syn_sorted),
        batch.syndromes[np.asarray(dec.tables.cn_order)],
    )


def test_seam_mode_tables_and_equivalence():
    """Seam-lattice shifts (the shipped codes' lattice) match XLA exactly."""
    import jax.numpy as jnp

    code, s = make_qc_code(BASE_36, Z=1024, seed=6, coarse=256, fine_mod=4)
    ch = BIAWGNChannel(0.8)
    dec_pl, dec_xla = _decoders(code, s, ch)
    t = dec_pl.tables
    assert dec_pl.kernel == "triton"
    n = 8
    batch = create_data(code, ch, 0, n)
    vn_order = np.asarray(t.vn_order)
    cn_order = np.asarray(t.cn_order)
    llr2d = jnp.asarray(ch.llr_np(batch.values)[vn_order][:, :n])
    syn2d = jnp.asarray(batch.syndromes[cn_order][:, :n])
    m_pl = dec_pl._init_messages(llr2d, t)
    m_xla = dec_xla._init_messages(llr2d, dec_xla.tables)
    for k in (1, 3):
        m2, bits_pl, viol_pl = dec_pl._run_iterations(m_pl, llr2d, syn2d, t, k)
        _, bits_xla, viol_xla = dec_xla._run_iterations(
            m_xla, llr2d, syn2d, dec_xla.tables, k)
        np.testing.assert_array_equal(np.asarray(bits_pl),
                                      np.asarray(bits_xla))
        np.testing.assert_array_equal(np.asarray(viol_pl),
                                      np.asarray(viol_xla))


def test_wide_seam_divides_tile_and_matches_oracle():
    """Shifts far off any tile boundary (fine_mod=20): rotated rows that
    wrap around the circulant mid-tile still match the oracle."""
    import jax.numpy as jnp

    code, s = make_qc_code(BASE_36, Z=1024, seed=11, coarse=256, fine_mod=20)
    ch = BIAWGNChannel(0.8)
    dec_pl, dec_xla = _decoders(code, s, ch)
    t = dec_pl.tables
    n = 8
    batch = create_data(code, ch, 0, n)
    vn_order = np.asarray(t.vn_order)
    cn_order = np.asarray(t.cn_order)
    llr2d = jnp.asarray(ch.llr_np(batch.values)[vn_order][:, :n])
    syn2d = jnp.asarray(batch.syndromes[cn_order][:, :n])
    m_pl = dec_pl._init_messages(llr2d, t)
    m_xla = dec_xla._init_messages(llr2d, dec_xla.tables)
    m2, bits_pl, viol_pl = dec_pl._run_iterations(m_pl, llr2d, syn2d, t, 3)
    _, bits_xla, viol_xla = dec_xla._run_iterations(
        m_xla, llr2d, syn2d, dec_xla.tables, 3)
    np.testing.assert_array_equal(np.asarray(bits_pl), np.asarray(bits_xla))
    np.testing.assert_array_equal(np.asarray(viol_pl), np.asarray(viol_xla))


def test_seam_mode_end_to_end():
    code, s = make_qc_code(BASE_36, Z=512, seed=7, coarse=128, fine_mod=4)
    ch = BIAWGNChannel(0.72)
    dec_pl, _ = _decoders(code, s, ch)
    dyn = DynamicParams(num_iter_max=40, num_iter_check_parity=5,
                        loading_factor=2)
    n = dec_pl.parallel_factor() * dyn.loading_factor
    batch = create_data(code, ch, 0, n)
    res, _ = dec_pl.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ res).sum()
    assert errors == 0


@pytest.mark.parametrize("sp_extra", [
    dict(minsum_offset=0.5),
    dict(minsum_offset=0.0, minsum_alpha=0.8125),  # normalized min-sum
])
def test_minsum_pallas_matches_xla(sp_extra):
    import jax.numpy as jnp

    code, s = make_qc_code(BASE_36, Z=512, seed=8, coarse=128, fine_mod=4)
    ch = BIAWGNChannel(0.8)
    sp = dict(max_log_parallel_factor_user=3, algorithm="min-sum",
              **sp_extra)
    dec_pl = LDPCDecoder(code, ch, StaticParams(
        kernel_impl="pallas", pallas_interpret=True, **sp), qc=s)
    dec_xla = LDPCDecoder(code, ch, StaticParams(kernel_impl="xla", **sp),
                          qc=s)
    n = 8
    batch = create_data(code, ch, 0, n)
    t = dec_pl.tables
    llr2d = jnp.asarray(ch.llr_np(batch.values)[np.asarray(t.vn_order)][:, :n])
    syn2d = jnp.asarray(batch.syndromes[np.asarray(t.cn_order)][:, :n])
    m_pl = dec_pl._init_messages(llr2d, t)
    m_xla = dec_xla._init_messages(llr2d, dec_xla.tables)
    for k in (1, 3):
        _, bits_pl, viol_pl = dec_pl._run_iterations(m_pl, llr2d, syn2d, t, k)
        _, bits_xla, viol_xla = dec_xla._run_iterations(
            m_xla, llr2d, syn2d, dec_xla.tables, k)
        np.testing.assert_array_equal(np.asarray(bits_pl),
                                      np.asarray(bits_xla))
        np.testing.assert_array_equal(np.asarray(viol_pl),
                                      np.asarray(viol_xla))


def test_minsum_decodes_end_to_end():
    code, s = make_qc_code(BASE_36, Z=512, seed=9, coarse=128, fine_mod=4)
    ch = BIAWGNChannel(0.7)
    dec = LDPCDecoder(
        code, ch,
        StaticParams(max_log_parallel_factor_user=3, algorithm="min-sum",
                     message_dtype="bfloat16", kernel_impl="pallas",
                     pallas_interpret=True),
        qc=s,
    )
    dyn = DynamicParams(num_iter_max=50, num_iter_check_parity=5,
                        loading_factor=2)
    n = dec.parallel_factor() * 2
    batch = create_data(code, ch, 0, n)
    res, _ = dec.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ res).sum()
    assert errors == 0
