"""Delayed first parity check (DynamicParams.num_iter_first_check).

The burst phase must be a bit-identical prefix of the superstep runner:
burst(b) followed by run_iterations(k) equals run_iterations(b+k) on the
message state and every emitted result, for every kernel path. The
decode-level tests check the retire grid {first_check, first_check+k, ...}
and that decoding stays exact.
"""

import jax
import numpy as np
import pytest

from ldpc_decoder_tpu.channels import BIAWGNChannel
from ldpc_decoder_tpu.codes.protographs import ru_irregular_base
from ldpc_decoder_tpu.codes.qc import make_qc_code
from ldpc_decoder_tpu.runtime.datagen import create_data
from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams

BASE_36 = np.ones((3, 6), dtype=np.int8)


def _prefix_identity(dec, llr2d, syn2d, b=3, k=2):
    m0 = dec._init_messages(llr2d, dec.tables)
    mb = dec._run_burst(m0, llr2d, syn2d, dec.tables, b)
    m1, bits1, viol1 = dec._run_iterations(mb, llr2d, syn2d, dec.tables, k)
    m2, bits2, viol2 = dec._run_iterations(m0, llr2d, syn2d, dec.tables,
                                           b + k)
    for a, c in zip(jax.tree_util.tree_leaves(m1),
                    jax.tree_util.tree_leaves(m2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    np.testing.assert_array_equal(np.asarray(bits1), np.asarray(bits2))
    np.testing.assert_array_equal(np.asarray(viol1), np.asarray(viol2))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_burst_prefix_identity_regular(impl):
    import jax.numpy as jnp

    code, s = make_qc_code(BASE_36, Z=64, seed=2)
    ch = BIAWGNChannel(0.8)
    dec = LDPCDecoder(code, ch, StaticParams(
        max_log_parallel_factor_user=3, kernel_impl=impl,
        pallas_interpret=True), qc=s)
    n = 8
    batch = create_data(code, ch, 0, n)
    llr2d = jnp.asarray(
        ch.llr_np(batch.values)[np.asarray(dec.tables.vn_order)][:, :n])
    syn2d = jnp.asarray(
        batch.syndromes[np.asarray(dec.tables.cn_order)][:, :n])
    _prefix_identity(dec, llr2d, syn2d)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_burst_prefix_identity_grouped(impl):
    import jax.numpy as jnp

    base, _ = ru_irregular_base(3, seed=4)
    code, s = make_qc_code(base, Z=256, seed=5)
    ch = BIAWGNChannel(0.8)
    dec = LDPCDecoder(code, ch, StaticParams(
        max_log_parallel_factor_user=3, kernel_impl=impl,
        pallas_interpret=True), qc=s)
    assert dec.kernel == ("triton" if impl == "pallas" else "xla")
    n = 8
    batch = create_data(code, ch, 0, n)
    llr2d = jnp.asarray(
        ch.llr_np(batch.values)[np.asarray(dec.tables.vn_order)][:, :n])
    syn2d = jnp.asarray(
        batch.syndromes[np.asarray(dec.tables.cn_order)][:, :n])
    _prefix_identity(dec, llr2d, syn2d)


def test_burst_prefix_identity_general_path():
    import jax.numpy as jnp

    code, _ = make_qc_code(BASE_36, Z=64, seed=2)
    ch = BIAWGNChannel(0.8)
    dec = LDPCDecoder(code, ch, StaticParams(
        max_log_parallel_factor_user=3))  # no qc= -> general gather path
    n = 8
    batch = create_data(code, ch, 0, n)
    llr2d = jnp.asarray(
        ch.llr_np(batch.values)[np.asarray(dec.cc.vn_order)][:, :n])
    syn2d = jnp.asarray(
        batch.syndromes[np.asarray(dec.cc.cn_order)][:, :n])
    _prefix_identity(dec, llr2d, syn2d)


@pytest.mark.parametrize("host_poll", [False, True])
def test_decode_with_first_check(host_poll):
    code, s = make_qc_code(BASE_36, Z=128, seed=3)
    ch = BIAWGNChannel(0.72)
    dec = LDPCDecoder(code, ch, StaticParams(
        max_log_parallel_factor_user=3, kernel_impl="pallas",
        pallas_interpret=True), qc=s)
    n = dec.parallel_factor() * 2
    batch = create_data(code, ch, 0, n)
    k = 3
    base = DynamicParams(num_iter_max=60, num_iter_check_parity=k,
                         loading_factor=2)
    res0, st0 = dec.decode(base, n, batch.values, batch.syndromes,
                           host_poll=host_poll)
    fc = 2 * k
    burst = fc - k
    res1, st1 = dec.decode(
        DynamicParams(num_iter_max=60, num_iter_check_parity=k,
                      num_iter_first_check=fc, loading_factor=2),
        n, batch.values, batch.syndromes, host_poll=host_poll)
    ref = batch.ref_bits_packed()
    assert int(np.bitwise_count(ref ^ res0).sum()) == 0
    assert int(np.bitwise_count(ref ^ res1).sum()) == 0
    # first-generation lanes retire on the {fc, fc+k, ...} grid
    gen1 = st1.iterations[: dec.parallel_factor()]
    assert (gen1 >= fc).all() and ((gen1 - fc) % k == 0).all()
    # iteration accounting includes the burst
    assert st1.total_iterations == st1.total_supersteps * k + burst
    # when nothing converges during the burst, results and per-frame
    # iteration counts are identical to the fixed-period run (the control
    # run's minimum must clear the burst for the grids to coincide)
    if st0.min_iter > fc:
        np.testing.assert_array_equal(res0, res1)
        np.testing.assert_array_equal(st0.iterations, st1.iterations)


def test_decode_sharded_with_first_check():
    from ldpc_decoder_tpu.parallel.mesh import make_batch_mesh

    code, s = make_qc_code(BASE_36, Z=128, seed=3)
    ch = BIAWGNChannel(0.7)
    mesh = make_batch_mesh(4)
    dec = LDPCDecoder(code, ch, StaticParams(
        max_log_parallel_factor_user=2, kernel_impl="pallas",
        pallas_interpret=True), qc=s)
    dyn = DynamicParams(num_iter_max=50, num_iter_check_parity=5,
                        num_iter_first_check=10, loading_factor=2)
    n = dec.parallel_factor() * dyn.loading_factor * 4
    batch = create_data(code, ch, 0, n)
    results, stats = dec.decode_sharded(
        dyn, n, batch.values, batch.syndromes, mesh)
    assert int(np.bitwise_count(batch.ref_bits_packed() ^ results).sum()) == 0
    # gen-1 lanes sit on the {10, 15, ...} grid; refilled lanes on {5, 10,
    # ...} (the burst applies to the initial generation only)
    assert (stats.iterations % 5 == 0).all()
    assert stats.iterations.max() >= 10
    assert stats.total_iterations == stats.total_supersteps * 5 + 5
