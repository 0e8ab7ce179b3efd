"""Kernel choice per backend and message dtype, the memory model's device
memory, the compile-cache path, the byte counts of runtime/perf.py and the
kernels' tile shapes. Tests marked ``gpu`` run the compiled kernels; they
skip without a card (run them with ``pytest --gpu -m gpu`` on one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_decoder_tpu.channels import BIAWGNChannel
from ldpc_decoder_tpu.codes.qc import make_qc_code
from ldpc_decoder_tpu.ops.qc_triton import tile_config
from ldpc_decoder_tpu.runtime import perf
from ldpc_decoder_tpu.runtime.datagen import create_data
from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder, choose_kernel
from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams

BASE_36 = np.ones((3, 6), np.int8)


@pytest.mark.parametrize("impl,qc,platform,dtype,interp,want", [
    ("auto", True, "gpu", "bfloat16", False, "triton"),
    ("auto", True, "gpu", "float32", False, "triton"),
    ("auto", True, "gpu", "int8", False, "triton"),
    ("auto", True, "gpu", "float8_e5m2", False, "xla"),
    ("auto", False, "gpu", "bfloat16", False, "xla"),
    ("auto", True, "cpu", "bfloat16", False, "xla"),
    ("auto", True, "cpu", "bfloat16", True, "xla"),
    ("xla", True, "gpu", "bfloat16", False, "xla"),
    ("pallas", True, "gpu", "bfloat16", False, "triton"),
    ("pallas", True, "cpu", "float32", True, "triton"),
])
def test_choose_kernel(impl, qc, platform, dtype, interp, want):
    alg = "min-sum" if dtype == "int8" else "sum-product"
    sp = StaticParams(kernel_impl=impl, message_dtype=dtype, algorithm=alg,
                      pallas_interpret=interp)
    assert choose_kernel(sp, qc, platform) == want


@pytest.mark.parametrize("impl,qc,platform,dtype,match", [
    ("pallas", True, "cpu", "bfloat16", "compile only for a GPU"),
    ("pallas", True, "rocm", "bfloat16", "compile only for a GPU"),
    ("pallas", True, "gpu", "float8_e5m2", "message dtypes"),
    ("pallas", False, "gpu", "bfloat16", "quasi-cyclic"),
    ("triton", True, "gpu", "bfloat16", "kernel_impl must be"),
])
def test_choose_kernel_refuses(impl, qc, platform, dtype, match):
    sp = StaticParams(kernel_impl=impl, message_dtype=dtype)
    with pytest.raises(ValueError, match=match):
        choose_kernel(sp, qc, platform)


def test_explicit_pallas_on_cpu_raises_at_construction():
    code, s = make_qc_code(BASE_36, Z=64, seed=1)
    with pytest.raises(ValueError, match="compile only for a GPU"):
        LDPCDecoder(code, BIAWGNChannel(0.8),
                    StaticParams(kernel_impl="pallas"), qc=s)


def test_auto_on_cpu_decodes_on_xla_and_fp8_is_xla_only():
    code, s = make_qc_code(BASE_36, Z=128, seed=3)
    ch = BIAWGNChannel(0.7)
    dec = LDPCDecoder(code, ch, StaticParams(
        max_log_parallel_factor_user=3, message_dtype="float8_e5m2"), qc=s)
    assert dec.kernel == "xla"
    dyn = DynamicParams(num_iter_max=40, num_iter_check_parity=5,
                        loading_factor=1)
    n = dec.parallel_factor()
    batch = create_data(code, ch, 0, n)
    res, _ = dec.decode(dyn, n, batch.values, batch.syndromes)
    assert int(np.bitwise_count(batch.ref_bits_packed() ^ res).sum()) == 0
    with pytest.raises(ValueError, match="message dtypes"):
        LDPCDecoder(code, ch, StaticParams(
            kernel_impl="pallas", pallas_interpret=True,
            message_dtype="float8_e5m2"), qc=s)


class _Dev:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _decoder_on(dev, **sp):
    code, s = make_qc_code(BASE_36, Z=64, seed=1)
    return LDPCDecoder(code, BIAWGNChannel(0.8), StaticParams(**sp),
                       device=dev, qc=s)


def test_device_memory_sources():
    dec = _decoder_on(_Dev("cpu", None))
    import os

    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert dec._device_memory() == host
    dec = _decoder_on(_Dev("cpu", None), device_memory_bytes=12345)
    assert dec._device_memory() == 12345
    dec = _decoder_on(_Dev("cpu", {"bytes_limit": 1 << 30}))
    assert dec._device_memory() == 1 << 30


def test_accelerator_without_bytes_limit_is_an_error():
    with pytest.raises(RuntimeError, match="bytes_limit"):
        _decoder_on(_Dev("gpu", {}))
    # an explicit size needs no report from the device
    dec = _decoder_on(_Dev("gpu", {}), device_memory_bytes=8 << 30)
    assert dec.kernel == "triton"


def test_memory_model_lanes_scale_with_device_memory():
    small = _decoder_on(_Dev("gpu", {"bytes_limit": 64 << 20}),
                        max_log_parallel_factor_user=20)
    big = _decoder_on(_Dev("gpu", {"bytes_limit": 1 << 30}),
                      max_log_parallel_factor_user=20)
    assert big.parallel_factor() >= 8 * small.parallel_factor()


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_default_dir(monkeypatch, restore_cache_dir):
    import os

    from ldpc_decoder_tpu.runtime import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir,
                                   tmp_path):
    from ldpc_decoder_tpu.runtime import compile_cache

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # no other cache is configured in code
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_dir_is_git_ignored():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = open(os.path.join(repo, ".gitignore")).read().split()
    assert ".jax_cache/" in lines


def test_perf_byte_counts():
    # p41 at B = 256 with bf16 messages and LLRs
    e, nv, nc, B = 3244032, 1032192, 589824, 256
    cn, vn = perf.bytes_split(e, nv, nc, B, 2, 2)
    assert cn == (4 * e + nc) * B
    assert vn == (4 * e + 2 * nv) * B
    assert perf.bytes_per_iter(e, nv, nc, B) == cn + vn
    # the emit iteration also writes one int8 decision per variable
    assert (perf.bytes_per_iter(e, nv, nc, B, emit=True)
            == cn + vn + nv * B)


@pytest.mark.parametrize("d,Z,B,want", [
    (8, 18432, 256, (1, 256)),
    (3, 32768, 256, (2, 256)),
    (6, 64, 8, (32, 8)),
    (3, 18, 384, (2, 128)),
    (4, 7, 5, (1, 1)),
])
def test_tile_config(d, Z, B, want):
    T, LB = tile_config(d, Z, B)
    assert (T, LB) == want
    assert Z % T == 0 and B % LB == 0


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with --gpu on one)")


@pytest.mark.gpu
def test_compiled_kernels_match_oracle_on_gpu(gpu):
    import chip_smoke as cs
    from ldpc_decoder_tpu.codes.protographs import p41_code

    code, qc = p41_code(Z=512, m=4, coarse=64, fine_mod=16)
    out = cs.phase_kernel_vs_oracle(code, qc, 0.8, 7, 5)
    assert out["cn_pass_max_ulps"] <= cs.CN_PASS_ULP_TOL


@pytest.mark.gpu
def test_auto_takes_the_kernels_on_gpu(gpu):
    code, s = make_qc_code(BASE_36, Z=1024, seed=3)
    ch = BIAWGNChannel(0.72)
    dec = LDPCDecoder(code, ch, StaticParams(
        max_log_parallel_factor_user=7, message_dtype="bfloat16"), qc=s)
    assert dec.kernel == "triton"
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5,
                        loading_factor=2)
    n = dec.parallel_factor() * 2
    batch = create_data(code, ch, 0, n)
    res, _ = dec.decode(dyn, n, batch.values, batch.syndromes)
    assert int(np.bitwise_count(batch.ref_bits_packed() ^ res).sum()) == 0
    assert jnp.asarray(0).devices().pop().platform == "gpu"
