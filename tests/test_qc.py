"""QC-LDPC: structure generation, alist round-trip, and decode-path
equivalence between the rotation-based fast path and the general path."""

import numpy as np
import pytest

from ldpc_decoder_tpu.channels import BIAWGNChannel
from ldpc_decoder_tpu.codes.code import compute_syndrome
from ldpc_decoder_tpu.codes.compiled import compile_code
from ldpc_decoder_tpu.codes.qc import (
    QCStructure,
    load_qc_alist,
    make_qc_code,
    make_qc_structure,
    qc_to_code,
    write_qc_alist,
)
from ldpc_decoder_tpu.runtime.datagen import create_data
from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams

BASE_36 = np.ones((3, 6), dtype=np.int8)


def test_qc_structure_properties():
    s = make_qc_structure(BASE_36, Z=64, seed=0)
    assert s.n_base_edges == 18
    np.testing.assert_array_equal(s.row_degrees(), [6, 6, 6])
    np.testing.assert_array_equal(s.col_degrees(), [3] * 6)


def test_qc_code_expansion():
    s = make_qc_structure(BASE_36, Z=32, seed=1)
    code = qc_to_code(s)
    assert code.n_vars == 192 and code.n_checks == 96
    assert code.n_edges == 18 * 32
    np.testing.assert_array_equal(code.var_degrees, np.full(192, 3))
    np.testing.assert_array_equal(code.check_degrees, np.full(96, 6))
    # adjacency honors the lift rule: check (r,z) ~ var (c, (z+s)%Z)
    Z = 32
    S = {(r, c): sh for r, c, sh in zip(s.edge_row, s.edge_col, s.edge_shift)}
    for check in [0, 17, 95]:
        r, z = divmod(check, Z)
        nbrs = set(
            code.out_edge_to_in_bit[
                code.out_bit_to_edge[check] : code.out_bit_to_edge[check + 1]
            ].tolist()
        )
        expect = {c * Z + (z + S[(r, c)]) % Z for (rr, c) in S if rr == r}
        assert nbrs == expect


def test_qc_no_4cycles():
    s = make_qc_structure(BASE_36, Z=128, seed=2)
    code = qc_to_code(s)
    # brute-force: any two checks share at most one variable
    rows = [
        set(
            code.out_edge_to_in_bit[
                code.out_bit_to_edge[c] : code.out_bit_to_edge[c + 1]
            ].tolist()
        )
        for c in range(code.n_checks)
    ]
    import itertools

    for a, b in itertools.combinations(range(len(rows)), 2):
        assert len(rows[a] & rows[b]) <= 1


def test_qc_alist_roundtrip_with_headers(tmp_path):
    code, s = make_qc_code(BASE_36, Z=32, seed=3)
    path = str(tmp_path / "qc.alist")
    write_qc_alist(code, s, path)
    code2, s2 = load_qc_alist(path)
    assert s2 is not None and s2.Z == 32
    np.testing.assert_array_equal(s.edge_shift, s2.edge_shift)
    np.testing.assert_array_equal(
        code.out_edge_to_in_bit, code2.out_edge_to_in_bit
    )


def test_qc_decode_matches_general_path():
    code, s = make_qc_code(BASE_36, Z=64, seed=4)
    ch = BIAWGNChannel(0.75)
    sp = StaticParams(max_log_parallel_factor_user=3)
    dyn = DynamicParams(num_iter_max=40, num_iter_check_parity=5,
                        loading_factor=2)
    # qc_autodetect off: this test deliberately drives the GENERAL path
    # on a QC code to cross-check the two implementations
    from dataclasses import replace

    dec_gen = LDPCDecoder(code, ch, replace(sp, qc_autodetect=False))
    dec_qc = LDPCDecoder(code, ch, sp, qc=s)
    n = dec_gen.parallel_factor() * dyn.loading_factor
    batch = create_data(code, ch, 0, n)
    res_gen, st_gen = dec_gen.decode(dyn, n, batch.values, batch.syndromes)
    res_qc, st_qc = dec_qc.decode(dyn, n, batch.values, batch.syndromes)
    np.testing.assert_array_equal(res_gen, res_qc)
    # iteration counts: identical for the initial batch; REFILLED frames
    # may take one extra superstep on the QC path — its lane-reset refill
    # spends the first iteration after a refill resetting the lane
    # in-kernel (runtime/decoder.py), while the general path rebuilds the
    # message state eagerly
    B = dec_gen.parallel_factor()
    np.testing.assert_array_equal(st_gen.iterations[:B],
                                  st_qc.iterations[:B])
    diff = st_qc.iterations - st_gen.iterations
    k = dyn.num_iter_check_parity
    assert np.all((diff == 0) | (diff == k))
    assert np.all(diff[:B] == 0)


def test_qc_decode_corrects_errors():
    code, s = make_qc_code(BASE_36, Z=256, seed=5)  # 1536-bit code
    ch = BIAWGNChannel(0.7)
    dec = LDPCDecoder(code, ch, StaticParams(max_log_parallel_factor_user=3),
                      qc=s)
    dyn = DynamicParams(num_iter_max=50, num_iter_check_parity=10,
                        loading_factor=2)
    n = dec.parallel_factor() * dyn.loading_factor
    batch = create_data(code, ch, 0, n)
    results, stats = dec.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ results).sum(axis=1)
    assert errors.sum() == 0


def test_qc_device_pool_and_decode():
    """QC path with fully on-device datagen."""
    from ldpc_decoder_tpu.runtime.datagen_device import (
        count_bit_errors,
        create_pool_device,
    )

    code, s = make_qc_code(BASE_36, Z=64, seed=6)
    ch = BIAWGNChannel(0.7)
    dec = LDPCDecoder(code, ch, StaticParams(max_log_parallel_factor_user=3),
                      qc=s)
    dyn = DynamicParams(num_iter_max=50, num_iter_check_parity=5,
                        loading_factor=1)
    n = 32
    pool = create_pool_device(dec.cc, dec.tables, ch, 0, n)
    # cross-check device syndrome against numpy on the QC tables
    batch = create_data(code, ch, 0, n)
    np.testing.assert_array_equal(
        np.asarray(pool.syn_sorted),
        batch.syndromes[np.asarray(dec.tables.cn_order)],
    )
    results, _ = dec.decode_presorted(
        dyn, n, pool.values_sorted, pool.syn_sorted, fetch_results=False
    )
    errors = np.asarray(count_bit_errors(results, pool.ref_packed))
    assert errors.sum() == 0


def test_qc_alist_params_header(tmp_path):
    from ldpc_decoder_tpu.codes.qc import read_alist_params

    code, s = make_qc_code(BASE_36, Z=32, seed=3)
    path = str(tmp_path / "qc_params.alist")
    params = {"base": "test36", "Z": "32", "seed": "3"}
    write_qc_alist(code, s, path, params=params)
    assert read_alist_params(path) == params
    # the header must not break parsing (reference parser skips comments)
    code2, s2 = load_qc_alist(path)
    assert s2 is not None and s2.Z == 32
    np.testing.assert_array_equal(s.edge_shift, s2.edge_shift)
    # files without the header report None
    write_qc_alist(code, s, path)
    assert read_alist_params(path) is None


def test_qc_autodetection_upgrades_plain_alist():
    """A QC code loaded WITHOUT structure metadata (plain alist) is
    auto-detected and decoded through the QC fast path
    (codes/qc.detect_qc_structure; StaticParams.qc_autodetect)."""
    from ldpc_decoder_tpu.codes.qc import detect_qc_structure
    from ldpc_decoder_tpu.ops.qc_decode import QCDecodeTables

    code, s = make_qc_code(BASE_36, Z=256, seed=3, coarse=64, fine_mod=4)
    det = detect_qc_structure(code)
    assert det is not None and det.Z == 256
    np.testing.assert_array_equal(
        np.sort(det.edge_shift), np.sort(s.edge_shift))
    ch = BIAWGNChannel(0.7)
    dec = LDPCDecoder(code, ch, StaticParams(max_log_parallel_factor_user=3))
    assert isinstance(dec.tables, QCDecodeTables)
    dyn = DynamicParams(num_iter_max=40, num_iter_check_parity=5,
                        loading_factor=2)
    n = dec.parallel_factor() * 2
    batch = create_data(code, ch, 0, n)
    res, _ = dec.decode(dyn, n, batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ res).sum()
    assert errors == 0
    # random (non-QC) codes are left on the general path
    from ldpc_decoder_tpu.codes.generate import make_regular_code
    from ldpc_decoder_tpu.ops.decode import DecodeTables

    rnd = make_regular_code(1024, 3, 6, seed=5)
    dec2 = LDPCDecoder(rnd, ch, StaticParams(max_log_parallel_factor_user=2))
    assert isinstance(dec2.tables, DecodeTables)
