"""The port's kernels against the reference and against each other.

Parity classes, measured:
  * plain ``adamw_store_update_ref`` vs the reference's Pallas kernel run
    in interpret mode on the CPU (``repro.kernels.ops.adamw_store_update``):
    - from zero moments (the first Adam step): m' and v' BITWISE, w'
      within 4 ulp of max(|w|, |w - w'|);
    - from nonzero moments: XLA contracts ``b1*m + (1-b1)*g`` into one FMA
      where the port rounds the product first, so m' differs by up to one
      ulp of (1-b1)*g plus one ulp of m' (many integer-view steps where the
      two terms cancel), v' by at most 1 ulp, and w' by that m' difference
      carried through ``lr*m'/(c1*(sqrt(v'/c2)+eps))`` plus 4 ulp of
      max(|w|, |w - w'|).  bf16 weights: at most 1 bf16 step.
  * the CUDA kernel vs the plain version on the card: BITWISE (both round
    every operation to fp32 in the same order) -- a ``gpu`` test.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, fused_update, ops
from repro_torch.kernels.ref import adamw_store_update_ref, scalar_stack

torch.set_num_threads(2)

LR, B1, B2, EPS, WD = np.float32(3e-4), 0.9, 0.95, 1e-8, 0.1


def _inputs(n, first_step, seed=0):
    r = np.random.default_rng(seed)
    w = (r.standard_normal(n) * 0.05).astype(np.float32)
    g = (r.standard_normal(n) * 1e-3).astype(np.float32)
    if first_step:
        m = np.zeros(n, np.float32)
        v = np.zeros(n, np.float32)
    else:
        m = (r.standard_normal(n) * 1e-4).astype(np.float32)
        v = np.abs(r.standard_normal(n) * 1e-7).astype(np.float32)
    mask = (r.random(n) < 0.8).astype(np.float32)
    t = np.float32(1 if first_step else 3)
    c1 = np.float32(1) - np.float32(B1) ** t
    c2 = np.float32(1) - np.float32(B2) ** t
    return (w, g, m, v, mask), dict(lr=LR, b1=B1, b2=B2, eps=EPS, wd=WD,
                                     c1=c1, c2=c2)


def _ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))).astype(np.float64)


@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
@pytest.mark.parametrize("n", [1024 * 128, 1_000_003],
                         ids=["lanes", "ragged"])
@pytest.mark.parametrize("first_step", [True, False],
                         ids=["zero_moments", "moments"])
def test_adamw_plain_matches_reference(fmt, n, first_step):
    # imported here: the card's machine has no JAX and runs only the gpu
    # test of this file
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops

    arrs, kw = _inputs(n, first_step)
    jw, jm, jv = jax_ops.adamw_store_update(*map(jnp.asarray, arrs),
                                            fmt=fmt, **kw)
    tw, tm, tv = ops.adamw_store_update(*map(torch.from_numpy, arrs),
                                        fmt=fmt, **kw)
    assert tw.dtype == (torch.bfloat16 if fmt == "bf16" else torch.float32)
    assert tm.dtype == tv.dtype == torch.float32
    jm, jv, tm, tv = (np.asarray(x) for x in (jm, jv, tm, tv))
    w, g, m, v, mask = arrs
    f64 = np.float64
    if first_step:
        assert np.array_equal(tm.view(np.int32), jm.view(np.int32))
        assert np.array_equal(tv.view(np.int32), jv.view(np.int32))
        dupd = 0.0
    else:
        term = (np.float32(1) - np.float32(B1)) * g
        assert np.all(np.abs(f64(tm) - f64(jm)) <= _ulp(term) + _ulp(tm))
        assert np.all(np.abs(f64(tv) - f64(jv)) <= _ulp(tv))
        dupd = np.abs(f64(tm) - f64(jm)) / f64(kw["c1"]) / (
            np.sqrt(f64(tv) / f64(kw["c2"])) + EPS)
    if fmt == "bf16":
        a = np.asarray(jw.astype(jnp.float32)).view(np.int32) >> 16
        b = tw.float().numpy().view(np.int32) >> 16
        assert np.abs(a.astype(np.int64) - b).max() <= 1
        return
    jw, tw = np.asarray(jw), tw.numpy()
    step = np.abs(f64(w) - f64(tw))
    bound = f64(LR) * dupd + 4 * _ulp(np.maximum(np.abs(w), step))
    assert np.all(np.abs(f64(tw) - f64(jw)) <= bound)


def test_cpu_tensors_take_the_plain_version():
    arrs, kw = _inputs(4096, False)
    before = fused_update.adamw_store_update.launches
    w, g, m, v, mask = map(torch.from_numpy, arrs)
    got = ops.adamw_store_update(w, g, m, v, mask, **kw)
    want = adamw_store_update_ref(w, g, m, v, mask,
                                  scalar_stack(kw["lr"], B1, B2, EPS, WD,
                                               kw["c1"], kw["c2"]))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused_update.adamw_store_update.launches == before


def test_in_place_update_on_cpu():
    arrs, kw = _inputs(5000, False, seed=3)
    w, g, m, v, mask = (torch.from_numpy(a.copy()) for a in arrs)
    want = ops.adamw_store_update(w.clone(), g, m.clone(), v.clone(), mask,
                                  **kw)
    out = ops.adamw_store_update(w, g, m, v, mask, out=(w, m, v), **kw)
    assert out[0] is w and out[1] is m and out[2] is v
    for a, b in zip((w, m, v), want):
        assert torch.equal(a, b)


def test_other_devices_raise():
    arrs, kw = _inputs(64, True)
    t = [torch.from_numpy(a) for a in arrs]
    t[1] = t[1].to("meta")
    with pytest.raises(ValueError, match="all lie on the CPU"):
        ops.adamw_store_update(*t, **kw)


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it raises before any
    build or launch."""
    arrs, kw = _inputs(64, True)
    with pytest.raises(ValueError, match="CUDA"):
        fused_update.adamw_store_update(
            *map(torch.from_numpy, arrs),
            scalar_stack(kw["lr"], B1, B2, EPS, WD, kw["c1"], kw["c2"]))


def test_unported_epilogues_raise():
    """Every epilogue of the reference is ported now: the fp8 one returns
    the codes of w' beside the master on the CPU, and only an unknown
    format raises."""
    arrs, kw = _inputs(64, True)
    core, _, _ = ops.adamw_store_update(*map(torch.from_numpy, arrs),
                                        fmt="fp8_e4m3", **kw)
    assert core["codes"].dtype == torch.float8_e4m3fn
    assert core["master"].dtype == torch.float32
    with pytest.raises(ValueError, match="unknown store fmt"):
        ops.adamw_store_update(*map(torch.from_numpy, arrs), fmt="fp8_e3m4",
                               **kw)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises instead of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
def test_kernel_matches_plain_on_card(fmt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n, offset in ((1024 * 128, 0), (1_000_003, 0), (4096, 1)):
        arrs, kw = _inputs(n + offset, False, seed=n)
        t = [torch.from_numpy(a).cuda()[offset:] for a in arrs]
        before = fused_update.adamw_store_update.launches
        got = ops.adamw_store_update(*t, fmt=fmt, **kw)
        assert fused_update.adamw_store_update.launches == before + 1
        want = adamw_store_update_ref(
            *t, scalar_stack(kw["lr"], B1, B2, EPS, WD, kw["c1"], kw["c2"]),
            fmt)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (n, offset)
        if fmt == "fp32":
            w, m, v = (x.clone() for x in (t[0], t[2], t[3]))
            ops.adamw_store_update(w, t[1], m, v, t[4], out=(w, m, v), **kw)
            torch.cuda.synchronize()
            for a, b in zip((w, m, v), want):
                assert torch.equal(a, b), ("in place", n)


# --------------------------------------------------------------------------- #
# the block-wise INT8 kernels on the card (kernel vs plain version: BITWISE)
# --------------------------------------------------------------------------- #
# (rows, n, block, element offset): the vector path (block % 4 == 0, aligned
# pointers), a misaligned view (scalar path), an odd block (scalar path) and
# a block whose staged values need more than 48 KB of shared memory
CARD_CASES = [(1, 1024 * 96, 1024, 0), (3, 64 * 50, 64, 0),
              (2, 64 * 50, 64, 1), (2, 7 * 33, 7, 0), (1, 16384 * 3, 16384, 0)]


def _card_tensor(shape, offset, dtype, gen, scale=1.0):
    """Random values in a view that starts ``offset`` elements into its
    buffer (an odd offset takes the kernels' scalar path)."""
    import math
    n = math.prod(shape)
    buf = torch.empty(n + offset, dtype=dtype, device="cuda")
    buf[offset:] = torch.randn(n, generator=gen, device="cuda") * scale
    return buf[offset:].view(shape)


def _card_inputs(rows, n, offset, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = _card_tensor((rows, n), offset, torch.float32, gen)
    x[0, :min(n, 64)] = 0.0          # an all-zero block (block <= 64 cases)
    return x, gen


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quantize_dequantize_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import blockwise_quant, ref

    for rows, n, block, offset in CARD_CASES:
        x, _ = _card_inputs(rows, n, offset, seed=n + offset)
        x = x.to(dtype)
        before = blockwise_quant.quantize.launches
        codes, scales = ops.quantize(x, block)
        assert blockwise_quant.quantize.launches == before + 1
        want_c, want_s = ref.quantize_ref(x, block)
        torch.cuda.synchronize()
        assert torch.equal(codes, want_c), (rows, n, block, offset)
        assert torch.equal(scales.view(torch.int32),
                           want_s.view(torch.int32)), (rows, n, block, offset)
        for out_dtype in (torch.float32, torch.bfloat16):
            before = blockwise_quant.dequantize_into.launches
            got = ops.dequantize_into(codes, scales, block,
                                      out_dtype=out_dtype)
            assert blockwise_quant.dequantize_into.launches == before + 1
            want = ref.dequantize_into_ref(codes, scales, block, out_dtype)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype and torch.equal(got, want), (
                rows, n, block, offset, out_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_encode_ef_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import encode_ef as ef_kernel, ref

    for rows, n, block, offset in CARD_CASES:
        ct, gen = _card_inputs(rows, n, offset, seed=2 * n + offset)
        ct = ct.to(dtype)
        ef = _card_tensor((rows, n), offset, torch.float32, gen, 1e-2)
        before = ef_kernel.encode_ef.launches
        got = ops.encode_ef(ct, ef, block)
        assert ef_kernel.encode_ef.launches == before + 1
        want = ref.encode_ef_ref(ct, ef, block)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (
                rows, n, block, offset)
        # the residual updated in place, as the gather's backward does
        codes, scales = torch.empty_like(got[0]), torch.empty_like(got[1])
        ops.encode_ef(ct, ef, block, out=(codes, scales, ef))
        torch.cuda.synchronize()
        for a, b in zip((codes, scales, ef), want):
            assert torch.equal(a, b), ("in place", rows, n, block, offset)


@pytest.mark.gpu
def test_adamw_q8_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for rows, n, block, offset in CARD_CASES:
        arrs, kw = _inputs(rows * n + offset, False, seed=n)
        t = [torch.from_numpy(a).cuda()[offset:].reshape(rows, n)
             for a in arrs]
        before = fused_update.adamw_q8_update.launches
        core, m2, v2 = ops.adamw_store_update(*t, fmt="q8_block",
                                              block=block, **kw)
        assert fused_update.adamw_q8_update.launches == before + 1
        want, wm, wv = adamw_store_update_ref(
            *t, scalar_stack(kw["lr"], B1, B2, EPS, WD, kw["c1"], kw["c2"]),
            "q8_block", block)
        torch.cuda.synchronize()
        for k in ("codes", "master", "scales"):
            assert torch.equal(core[k], want[k]), (k, rows, n, block, offset)
        assert torch.equal(m2, wm) and torch.equal(v2, wv)
        # in place on the state's tensors, as the optimizer runs it
        w, m, v = (x.clone() for x in (t[0], t[2], t[3]))
        codes = torch.empty_like(core["codes"])
        scales = torch.empty_like(core["scales"])
        ops.adamw_store_update(w, t[1], m, v, t[4], fmt="q8_block",
                               block=block, out=(codes, w, scales, m, v),
                               **kw)
        torch.cuda.synchronize()
        for a, b in zip((codes, w, scales, m, v),
                        (want["codes"], want["master"], want["scales"], wm,
                         wv)):
            assert torch.equal(a, b), ("in place", rows, n, block, offset)
