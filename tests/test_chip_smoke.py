"""chip_smoke.py's phase functions on tiny codes, on the CPU (kernels in
interpret mode). Only main() insists on a GPU."""

import numpy as np
import pytest

import chip_smoke as cs
from ldpc_decoder_tpu.codes.generate import make_regular_code
from ldpc_decoder_tpu.codes.protographs import p41_code
from ldpc_decoder_tpu.codes.qc import make_qc_code


@pytest.fixture(scope="module")
def tiny_p41():
    return p41_code(Z=128, m=4, coarse=64, fine_mod=16)


def test_main_refuses_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])


def test_phase_kernel_vs_oracle_tiny(tiny_p41):
    code, qc = tiny_p41
    out = cs.phase_kernel_vs_oracle(code, qc, 0.8, 5, 3, interpret=True)
    # both paths evaluate through XLA:CPU here: identical to the last bit
    assert out["cn_pass_max_ulps"] == 0
    assert out["cn_pass_msgs_differing"] == 0.0
    assert out["k_iter_violated_equal"]
    assert out["k_iter_bit_disagreement"] == 0.0


@pytest.mark.parametrize("dtype,bits", [(np.float32, np.int32),
                                        ("bfloat16", np.int16),
                                        (np.int8, np.int8)])
def test_ulp_distance(dtype, bits):
    import jax.numpy as jnp

    x = np.asarray(jnp.asarray([1, -1, 0, 3], dtype))
    y = (x.view(bits) + np.array([1, 1, 0, 0], bits)).view(x.dtype)
    d = cs._ulp_distance(x, y)
    # one step of the bit pattern is one ulp for floats, one unit for int8
    assert d.tolist() == [1, 1, 0, 0]
    if dtype != np.int8:
        # +0 and -0 are the same value: no ulp between them
        z = np.asarray(jnp.asarray([0.0, -0.0], dtype))
        assert cs._ulp_distance(z[:1], z[1:]).tolist() == [0]


def test_phase_end_to_end_and_host_fed_tiny(tiny_p41):
    code, qc = tiny_p41
    out, dec, dyn, (pool, res) = cs.phase_end_to_end(
        "tiny_p41", code, qc, 0.75, 3, 32, 5, 60, first_check=10,
        kernel_impl="pallas", pallas_interpret=True)
    assert out["kernel"] == "triton" and out["fer1"] == 0.0
    hf = cs.phase_host_fed(dec, dyn, pool, res, n=16, chunk=8)
    assert hf["equal_to_device_pool"]


def test_phase_end_to_end_general_path_tiny():
    code = make_regular_code(512, 3, 6, seed=9)
    out, *_ = cs.phase_end_to_end("tiny_random36", code, None, 0.7, 3, 32,
                                  5, 60, qc_autodetect=False)
    assert out["kernel"] == "xla" and out["fer1"] == 0.0


def test_phase_cli_tiny(tmp_path):
    from ldpc_decoder_tpu.codes.qc import write_qc_alist

    code, s = make_qc_code(np.ones((3, 6), np.int8), Z=64, seed=3)
    path = str(tmp_path / "c.alist")
    write_qc_alist(code, s, path)
    assert cs.phase_cli(path, 0.7, 3, 1, 40) == 0


def test_phase_multi_tiny():
    base = np.ones((3, 6), np.int8)
    code, qc = make_qc_code(base, Z=128, seed=3)
    out = cs.phase_multi(code, qc, 0.7, 2, 4, 8, 5, 40,
                         kernel_impl="pallas", pallas_interpret=True)
    assert out["frames_bits_differ"] == 0 and out["devices"] == 4
