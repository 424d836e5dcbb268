"""The port's int8 x int8 ``q8_matmul`` against the reference and on the card.

Parity classes, measured:
  * plain ``q8_matmul_ref`` vs the reference's Pallas kernel in interpret
    mode on the CPU (``repro.kernels.ops.q8_matmul``): BITWISE on every
    case below (case A, case B, case B with a trailing partial block,
    leading batch dims, fp32 and bf16 x and out, a row of zeros).  XLA
    compiles the kernel's ``rmax / 127.0`` to a multiply by float32(1/127)
    and keeps ``1.0 / max(rs, 1e-30)`` a true divide; the plain version
    does the same.
  * the index transforms (``quant_eligible``, ``fold_scales``,
    ``q8_slice_cols``): BITWISE, including the ``None`` cases.
  * the CUDA kernel vs the plain version on the card: BITWISE (integer
    products summed exactly, every float step explicitly rounded in the
    same order) -- a ``gpu`` test.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import q8_matmul as q8mm
from repro_torch.kernels.ref import q8_matmul_ref

torch.set_num_threads(2)

# (lead dims of x, K, N, block): case A with nj = 1 and nj = 3, case B
# (r = 4), case B with a trailing partial block (K * N / block = 24.5)
CASES = {
    "A_nj1": ((5,), 96, 64, 64),
    "A_nj3": ((2, 3), 80, 192, 64),
    "B": ((7,), 96, 16, 64),
    "B_partial": ((3, 2), 98, 16, 64),
}
DTYPES = {"f32": (torch.float32, torch.float32),
          "bf16": (torch.bfloat16, torch.bfloat16),
          "bf16_in_f32_out": (torch.bfloat16, torch.float32),
          "f32_in_bf16_out": (torch.float32, torch.bfloat16)}


def _jax():
    """The reference, imported inside the CPU tests: the card's machine
    has no JAX and runs only the gpu test of this file."""
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops
    from repro.kernels import q8_matmul as jax_q8
    return jnp, jax_ops, jax_q8


def _weight(k, n, block, seed):
    """int8 codes and their flat block scales (ceil count), as a q8_block
    store holds them."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (k, n)).astype(np.int8)
    nb = -(-(k * n) // block)
    scales = rng.uniform(1e-3, 5e-2, nb).astype(np.float32)
    return codes, scales


def _x(lead, k, seed, dtype):
    """Rows of mixed magnitude, one of them all zeros (rs = 0), rounded to
    ``dtype`` once and shared by both packages."""
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal(lead + (k,)) * rng.uniform(
        0.01, 30.0, lead + (1,))
    x.reshape(-1, k)[1] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _jnp_dtype(dtype):
    jnp = _jax()[0]
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _to_jnp(t):
    return _jax()[0].asarray(t.float().numpy()).astype(_jnp_dtype(t.dtype))


def _int_view(t):
    t = t.contiguous()
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(view[t.dtype]).long()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_reference(case, dt):
    jnp, jax_ops, _ = _jax()
    lead, k, n, block = CASES[case]
    x_dtype, out_dtype = DTYPES[dt]
    codes, scales = _weight(k, n, block, seed=k + n)
    x = _x(lead, k, seed=k, dtype=x_dtype)
    want = jax_ops.q8_matmul(_to_jnp(x), jnp.asarray(codes),
                             jnp.asarray(scales), block,
                             out_dtype=_jnp_dtype(out_dtype))
    got = ops.q8_matmul(x, torch.from_numpy(codes), torch.from_numpy(scales),
                        block, out_dtype=out_dtype)
    assert got.dtype == out_dtype and tuple(got.shape) == lead + (n,)
    want_t = torch.from_numpy(np.array(want.astype(jnp.float32))
                              ).to(out_dtype)
    assert torch.equal(_int_view(got), _int_view(want_t))
    assert not got.reshape(-1, n)[1].any()       # the zero row stays zero


def test_plain_tracks_dense_product():
    """The function's own class: ALLCLOSE to x @ dequantize(w), the row
    quantization's error about 1/254 per element (measured: relative L2
    9.4e-3 here, random codes under per-block scales); asserted 3e-2."""
    codes, scales = _weight(256, 128, 64, seed=3)
    x = _x((16,), 256, seed=3, dtype=torch.float32)
    dense = (torch.from_numpy(codes).float().reshape(-1, 64)
             * torch.from_numpy(scales)[:, None]).reshape(256, 128)
    got = ops.q8_matmul(x, torch.from_numpy(codes), torch.from_numpy(scales),
                        64)
    want = x @ dense
    assert float((got - want).norm() / want.norm()) < 3e-2


def _error_text(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("k,n,block,n_scales", [
    (64, 128, 64, 127),    # case A, one scale short
    (96, 16, 64, 23),      # case B, the ceil count is 24
    (98, 16, 64, 24),      # case B with the partial block: 25 needed
    (64, 48, 64, 48),      # neither case: no separable layout
])
def test_value_errors_match_reference(k, n, block, n_scales):
    jnp, jax_ops, _ = _jax()
    codes = np.zeros((k, n), np.int8)
    scales = np.ones(n_scales, np.float32)
    x = np.ones((2, k), np.float32)
    ref = _error_text(lambda: jax_ops.q8_matmul(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales), block))
    port = _error_text(lambda: ops.q8_matmul(
        torch.from_numpy(x), torch.from_numpy(codes),
        torch.from_numpy(scales), block))
    assert port == ref


def test_fold_scales_error_matches_reference():
    jnp, _, jax_q8 = _jax()
    ref = _error_text(lambda: jax_q8.fold_scales(jnp.ones(48), 64, 48, 64))
    port = _error_text(lambda: q8mm.fold_scales(torch.ones(48), 64, 48, 64))
    assert port == ref


def test_int32_depth_limit():
    """K * 127**2 must fit the int32 accumulator: the deepest K runs, one
    more raises on every device before any work."""
    assert q8mm.MAX_K * 127 * 127 < 2 ** 31 <= (q8mm.MAX_K + 1) * 127 * 127
    k = q8mm.MAX_K + 1
    with pytest.raises(ValueError, match="overflow the int32"):
        ops.q8_matmul(torch.ones(1, k), torch.zeros(k, 64, dtype=torch.int8),
                      torch.ones(k), 64)


@pytest.mark.parametrize("shape,block", [
    ((64, 128), 64), ((64, 64), 64), ((96, 16), 64), ((98, 16), 64),
    ((64, 48), 64), ((64,), 64), ((2, 64, 64), 64), ((2304, 2048), 1024),
    ((9216, 2304), 1024), ((4096, 128), 1024)])
def test_quant_eligible_matches_reference(shape, block):
    jax_q8 = _jax()[2]
    assert q8mm.quant_eligible(shape, block) == jax_q8.quant_eligible(
        shape, block)


@pytest.mark.parametrize("k,n,block", [(64, 128, 64), (96, 16, 64),
                                       (98, 16, 64), (5, 8, 8)])
def test_fold_scales_matches_reference(k, n, block):
    jnp, _, jax_q8 = _jax()
    _, scales = _weight(k, n, block, seed=k)
    got = q8mm.fold_scales(torch.from_numpy(scales), k, n, block)
    want = np.asarray(jax_q8.fold_scales(jnp.asarray(scales), k, n, block))
    assert got.shape == want.shape
    assert np.array_equal(got.contiguous().numpy(), want)


@pytest.mark.parametrize("k,n,block,start,width", [
    (96, 16, 64, 4, 8),      # case B: any slice, per-row scales
    (98, 16, 64, 0, 16),     # case B with the partial block
    (64, 256, 64, 128, 64),  # case A: a whole-block slice
    (64, 256, 64, 32, 64),   # case A, start inside a block: None
    (64, 256, 64, 0, 32),    # case A, width not a block multiple: None
    (64, 48, 64, 0, 16),     # neither case: None
])
def test_q8_slice_cols_matches_reference(k, n, block, start, width):
    jnp, _, jax_q8 = _jax()
    codes, scales = _weight(k, n, block, seed=n)
    ref = jax_q8.q8_slice_cols(
        jax_q8.QuantTensor(jnp.asarray(codes), jnp.asarray(scales), block),
        start, width)
    port = q8mm.q8_slice_cols(
        q8mm.QuantTensor(torch.from_numpy(codes), torch.from_numpy(scales),
                         block), start, width)
    if ref is None:
        assert port is None
        return
    assert port.block == ref.block
    assert np.array_equal(port.codes.numpy(), np.asarray(ref.codes))
    assert np.array_equal(port.scales.numpy(), np.asarray(ref.scales))


def test_q8_slice_cols_width_error():
    qt = q8mm.QuantTensor(torch.zeros(4, 16, dtype=torch.int8),
                          torch.ones(1), 64)
    with pytest.raises(ValueError, match="out of range"):
        q8mm.q8_slice_cols(qt, 0, 17)


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it raises before any
    build or launch."""
    codes, scales = _weight(64, 64, 64, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        q8mm.q8_matmul(torch.ones(2, 64), torch.from_numpy(codes),
                       torch.from_numpy(scales), 64, torch.float32)


def test_regime_is_chosen_by_m_alone():
    """Decode (one launch, split K) up to DECODE_MAX_M rows, prefill
    (row quantization + wgmma GEMM) above; the decode kernel's register
    tile takes at most 16 rows."""
    assert 1 <= q8mm.DECODE_MAX_M <= 16
    assert [q8mm.regime_for(m) for m in (1, 4, q8mm.DECODE_MAX_M)] == \
        ["decode"] * 3
    assert [q8mm.regime_for(m) for m in (q8mm.DECODE_MAX_M + 1, 2048)] == \
        ["prefill"] * 2


# (K, N, block) on the card: case A with nj = 1 (K % 32 != 0), nj = 3 with a
# ragged last column tile of both regimes (group width 320), gemma2-2b's wq;
# case B with r = 8, with trailing partial blocks (K % r != 0), N = 7; a
# case-A group width of 8 (byte loads at decode, the aligned copy at
# prefill); llama-3.2-vision's K = 8192 and 28672, whose decode slab streams
# through two buffers in chunks
CARD_SHAPES = ((300, 64, 64), (1000, 960, 320), (2304, 2048, 1024),
               (1000, 128, 1024), (1001, 128, 1024), (4097, 512, 1024),
               (101, 7, 56), (97, 40, 8), (8192, 1024, 1024),
               (28672, 256, 1024))
CARD_M = (1, 4, 16, 17, 64, 2048)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
def test_kernel_matches_plain_on_card(dt):
    """Kernel vs plain version on the card: M either side of the decode /
    prefill crossover, both scale cases, K not a multiple of 32 or 256,
    ragged column tiles, codes 16-byte aligned and not, fp32 and bf16 in
    and out: 0 integer-view steps; one launch count a call, in its
    regime's count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x_dtype, out_dtype = DTYPES[dt]
    for k, n, block in CARD_SHAPES:
        codes, scales = _weight(k, n, block, seed=k + n)
        s = torch.from_numpy(scales).cuda()
        for misaligned in (False, True):
            buf = torch.zeros(k * n + 16, dtype=torch.int8, device="cuda")
            off = 1 if misaligned else 0
            c = buf[off:off + k * n].view(k, n)
            c.copy_(torch.from_numpy(codes))
            assert (c.data_ptr() % 16 != 0) == misaligned
            for m in CARD_M:
                x = _x((m,), k, seed=m, dtype=x_dtype).cuda() if m > 1 else \
                    torch.randn(1, k, dtype=x_dtype).cuda()
                regime = q8mm.regime_for(m)
                before = (q8mm.q8_matmul.launches,
                          getattr(q8mm.q8_matmul, f"{regime}_launches"))
                got = ops.q8_matmul(x, c, s, block, out_dtype=out_dtype)
                assert (q8mm.q8_matmul.launches, getattr(
                    q8mm.q8_matmul, f"{regime}_launches")) == \
                    (before[0] + 1, before[1] + 1)
                want = q8_matmul_ref(x, c, s, block, out_dtype)
                torch.cuda.synchronize()
                diff = int((_int_view(got) - _int_view(want)).abs().max())
                assert diff == 0, ((m, k, n, block, misaligned), diff)
