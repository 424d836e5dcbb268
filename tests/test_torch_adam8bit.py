"""8-bit Adam of the port against the JAX reference on the CPU, and its CUDA
kernel against its plain version on the card.

Inputs come from numpy seeds; the reference runs its Pallas kernel in
interpret mode through ``repro.kernels.ops`` (JAX is imported inside the CPU
tests only: the card's machine has none, and runs this file's ``gpu``
tests).  Parity classes, measured:
  * the log-space codec (``quant.blockwise``): XLA:CPU's ``exp`` is its own
    approximation, so a decoded value differs by up to 32 integer-view steps
    (exhaustive over the 127 nonzero codes); on the encode side codes and
    scales are BITWISE on these inputs but for blocks whose max is
    subnormal, which XLA:CPU flushes to scale 0 and codes 0.
  * the plain ``adam8bit_store_update`` vs the reference's interpreted
    kernel: the AdamW chain's class (XLA contracts ``b1*m + (1-b1)*g`` into
    an FMA) and, through v, the log decode's, carried into w' and the
    scales; the codes were bitwise on these inputs (a code can move by one
    where its value sits that close to a rounding boundary).  Bounds in
    ``BOUNDS``, measured values in the test's docstring.
  * the CUDA kernel vs the plain version on the card: BITWISE (``gpu``).
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import build_model, get_config
from repro_torch.core.fsdp import FSDPRuntime
from repro_torch.core.schedule import CommSchedule
from repro_torch.kernels import fused_update, ops, ref
from repro_torch.launch.mesh import init_local_group
from repro_torch.optim import Adam8bit, make_optimizer
from repro_torch.optim.common import matrix_mask_local
from repro_torch.quant import blockwise

torch.set_num_threads(2)

LR, B1, B2, EPS, WD = np.float32(3e-4), 0.9, 0.95, 1e-8, 0.1
SUBNORMAL = np.float32(2.0 ** -126)
# asserted bounds (measured worst cases in the test's docstring): w' in ulp
# of max(|w|, |w - w'|); scales in integer-view steps; codes by at most
# one, on at most the stated fraction of elements
BOUNDS = dict(w_ulp=4, scale_steps=2, code_frac=1e-4)
CASES = [(1, 64 * 40, 64), (3, 64 * 40, 64), (1, 1024 * 12, 1024),
         (3, 1024 * 12, 1024)]
IDS = ["b64-1row", "b64-3rows", "b1024-1row", "b1024-3rows"]


def _iv(a):
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize]) \
        .astype(np.int64)


def _ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))).astype(np.float64)


def _moments(rows, n, block, first_step, r):
    """int8 moment states from fp32 moments through the reference's
    codecs (zero codes and scales for the first step)."""
    import jax.numpy as jnp
    from repro.quant import blockwise as jb

    if first_step:
        z8 = np.zeros((rows, n), np.int8)
        zs = np.zeros((rows, n // block), np.float32)
        return z8, z8.copy(), zs, zs.copy()
    m = (r.standard_normal((rows, n)) * 1e-4).astype(np.float32)
    v = np.abs(r.standard_normal((rows, n)) * 1e-7).astype(np.float32)
    m8, ms = (np.asarray(a) for a in jb.quantize_blockwise(jnp.asarray(m),
                                                           block))
    v8, vs = (np.asarray(a) for a in jb.quantize_blockwise_log(
        jnp.asarray(v), block))
    return m8, v8, ms, vs


def _inputs(rows, n, block, first_step, seed):
    """Weights, gradients at per-block magnitudes from 5e-5 to 2e-2 (an
    all-zero gradient block among them), the moment states and one (S,)
    uint8 decay row."""
    r = np.random.default_rng(seed)
    w = (r.standard_normal((rows, n)) * 0.05).astype(np.float32)
    mag = np.exp(r.uniform(-3, 3, (rows, n // block, 1)))
    g = (r.standard_normal((rows, n // block, block)) * 1e-3 * mag) \
        .reshape(rows, n).astype(np.float32)
    g[0, :block] = 0.0
    m8, v8, ms, vs = _moments(rows, n, block, first_step, r)
    mask = (r.random(n) < 0.8).astype(np.uint8)
    t = np.float32(1 if first_step else 3)
    kw = dict(lr=LR, b1=B1, b2=B2, eps=EPS, wd=WD,
              c1=np.float32(1) - np.float32(B1) ** t,
              c2=np.float32(1) - np.float32(B2) ** t)
    return (w, g, m8, v8, ms, vs, mask), kw


# --------------------------------------------------------------------------- #
# the log-space codec
# --------------------------------------------------------------------------- #
def test_log_decode_matches_reference_exhaustively():
    """Every code at three scales: code 0 decodes to 0 on both sides; the
    others within 32 integer-view steps (XLA:CPU's exp, then the scale's
    product), 95 of the 127 codes bitwise at scale 1."""
    import jax.numpy as jnp
    from repro.quant import blockwise as jb

    codes = np.tile(np.arange(128, dtype=np.int8), (3, 1))
    scales = np.asarray([[1.0], [3.7e-9], [2.5e4]], np.float32)
    want = np.asarray(jb.dequantize_blockwise_log(jnp.asarray(codes),
                                                  jnp.asarray(scales), 128))
    got = blockwise.dequantize_blockwise_log(torch.from_numpy(codes),
                                             torch.from_numpy(scales), 128)
    got = got.numpy()
    assert np.all(got[:, 0] == 0) and np.all(want[:, 0] == 0)
    d = np.abs(_iv(got) - _iv(want))
    assert d.max() <= 32
    assert np.count_nonzero(d[0] == 0) >= 90
    # the op-level passthrough is the oracle
    assert torch.equal(ops.dequantize_log(torch.from_numpy(codes),
                                          torch.from_numpy(scales), 128),
                       torch.from_numpy(got))


@pytest.mark.parametrize("block", [64, 1024])
def test_log_encode_matches_reference(block):
    """Non-negative blocks over 20 decades, an all-zero block and a block
    whose max is subnormal: codes and scales BITWISE except in the
    subnormal block, which XLA:CPU flushes (scale 0, codes 0) and the port
    keeps."""
    import jax.numpy as jnp
    from repro.quant import blockwise as jb

    r = np.random.default_rng(block)
    nb = 24
    x = np.abs(r.standard_normal((2, nb, block))) * np.exp(
        r.uniform(-46, 0, (2, nb, 1))) * np.exp(r.uniform(-8, 0, (2, nb,
                                                                  block)))
    x[0, 0] = 0.0
    x[1, 3] = np.abs(r.standard_normal(block)) * 1e-40
    x = x.reshape(2, nb * block).astype(np.float32)
    jc, js = (np.asarray(a) for a in jb.quantize_blockwise_log(
        jnp.asarray(x), block))
    tc, ts = (a.numpy() for a in ops.quantize_log(torch.from_numpy(x),
                                                  block))
    assert tc.dtype == np.int8 and ts.shape == (2, nb)
    sub = ts < SUBNORMAL
    assert sub.sum() == 1 + 1 and js[sub][ts[sub] > 0].max() == 0
    keep = np.repeat(~sub, block, axis=-1)
    assert np.array_equal(tc[keep], jc[keep])
    assert np.array_equal(_iv(ts[~sub]), _iv(js[~sub]))
    assert np.all(jc[~keep] == 0)
    assert np.all(tc.reshape(2, nb, block)[0, 0] == 0)


def test_log_codec_blocking_contract():
    x = torch.ones(2, 96)
    for fn in (lambda: blockwise.quantize_blockwise_log(x, 64),
               lambda: blockwise.quantize_blockwise_log(x, 0),
               lambda: blockwise.dequantize_blockwise_log(
                   x.to(torch.int8), torch.ones(2, 1), 64),
               lambda: blockwise.dequantize_blockwise_log(
                   x.to(torch.int8), torch.ones(2, 2), 32)):
        with pytest.raises(ValueError, match="block|blocks"):
            fn()


# --------------------------------------------------------------------------- #
# the plain 8-bit Adam update against the reference's interpreted kernel
# --------------------------------------------------------------------------- #
def _assert_codes(got, want, frac):
    d = np.abs(got.astype(np.int64) - want)
    assert d.max() <= 1
    assert np.count_nonzero(d) <= frac * d.size


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "q8_block"])
@pytest.mark.parametrize("first_step", [True, False],
                         ids=["zero_moments", "moments"])
@pytest.mark.parametrize("rows,n,block", CASES, ids=IDS)
def test_adam8bit_plain_matches_reference(rows, n, block, first_step, fmt):
    """Measured over these cases: w' within 3 ulp of max(|w|, |w - w'|)
    (2 from zero moments; fp32 and the q8 master), bf16 w' bitwise; ms',
    vs' and the q8 scales of w' within 1 integer-view step; m8', v8' and
    the q8 codes of w' bitwise.  Asserted: ``BOUNDS``."""
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops

    arrs, kw = _inputs(rows, n, block, first_step, seed=n + rows)
    w, g, m8, v8, ms, vs, mask = arrs
    if fmt == "bf16":
        w = np.asarray(jnp.asarray(w).astype(jnp.bfloat16)
                       .astype(jnp.float32))
    full_mask = np.broadcast_to(mask.astype(np.float32), w.shape)
    jw = jnp.asarray(w).astype(jnp.bfloat16) if fmt == "bf16" \
        else jnp.asarray(w)
    jout = jax_ops.adam8bit_store_update(
        jw, *map(jnp.asarray, (g, m8, v8, ms, vs, full_mask)), fmt=fmt,
        block=block, **kw)
    tw = torch.from_numpy(w)
    if fmt == "bf16":
        tw = tw.to(torch.bfloat16)
    tout = ops.adam8bit_store_update(
        tw, *map(torch.from_numpy, (g, m8, v8, ms, vs, mask)), fmt=fmt,
        block=block, **kw)
    jcore, jm8, jv8, jms, jvs = (jout[0],) + tuple(
        np.asarray(a) for a in jout[1:])
    tcore, tm8, tv8, tms, tvs = (tout[0],) + tuple(
        a.numpy() for a in tout[1:])
    for a, b in ((tm8, jm8), (tv8, jv8), (tms, jms), (tvs, jvs)):
        assert a.dtype == b.dtype and a.shape == b.shape
    _assert_codes(tm8, jm8, BOUNDS["code_frac"])
    _assert_codes(tv8, jv8, BOUNDS["code_frac"])
    assert np.abs(_iv(tms) - _iv(jms)).max() <= BOUNDS["scale_steps"]
    assert np.abs(_iv(tvs) - _iv(jvs)).max() <= BOUNDS["scale_steps"]
    if fmt == "q8_block":
        assert list(tcore) == list(jcore) == ["codes", "master", "scales"]
        _assert_codes(tcore["codes"].numpy(), np.asarray(jcore["codes"]),
                      BOUNDS["code_frac"])
        tw2, jw2 = tcore["master"].numpy(), np.asarray(jcore["master"])
        assert np.abs(_iv(tcore["scales"].numpy())
                      - _iv(np.asarray(jcore["scales"]))).max() \
            <= BOUNDS["scale_steps"]
    elif fmt == "bf16":
        assert tcore.dtype == torch.bfloat16
        a = _iv(np.asarray(jcore.astype(jnp.float32))) >> 16
        b = _iv(tcore.float().numpy()) >> 16
        assert np.abs(a - b).max() <= 1  # one bf16 step
        return
    else:
        tw2, jw2 = tcore.numpy(), np.asarray(jcore)
    step = np.abs(w.astype(np.float64) - tw2)
    bound = BOUNDS["w_ulp"] * _ulp(np.maximum(np.abs(w), step))
    assert np.all(np.abs(tw2.astype(np.float64) - jw2) <= bound)


def test_adam8bit_plain_is_the_composition():
    """The fused plain version equals its unfused parts: decode, the AdamW
    plain step on the decoded moments, requantize (m linear, v log)."""
    arrs, kw = _inputs(2, 64 * 20, 64, False, seed=5)
    w, g, m8, v8, ms, vs, mask = map(torch.from_numpy, arrs)
    w2, m8o, v8o, mso, vso = ops.adam8bit_store_update(
        w, g, m8, v8, ms, vs, mask, block=64, **kw)
    m = blockwise.dequantize_blockwise(m8, ms, 64)
    v = ops.dequantize_log(v8, vs, 64)
    ww, wm, wv = ops.adamw_store_update(
        w, g, m, v, mask.float().expand_as(w), **kw)
    assert torch.equal(w2, ww)
    for a, b in zip((m8o, mso), blockwise.quantize_blockwise(wm, 64)):
        assert torch.equal(a, b)
    for a, b in zip((v8o, vso), ops.quantize_log(wv, 64)):
        assert torch.equal(a, b)


def test_adam8bit_in_place_on_cpu():
    arrs, kw = _inputs(2, 64 * 20, 64, False, seed=6)
    t = [torch.from_numpy(a.copy()) for a in arrs]
    want = ops.adam8bit_store_update(*[x.clone() for x in t], block=64, **kw)
    w, g, m8, v8, ms, vs, mask = t
    out = ops.adam8bit_store_update(w, g, m8, v8, ms, vs, mask, block=64,
                                    out=(w, m8, v8, ms, vs), **kw)
    assert all(a is b for a, b in zip(out, (w, m8, v8, ms, vs)))
    for a, b in zip((w, m8, v8, ms, vs), want):
        assert torch.equal(a, b)


def test_adam8bit_wrapper_contracts():
    """CPU tensors never reach the kernel wrapper; the mask must be one
    uint8 row (or a full fp32 mask); the fp8 epilogue runs and an unknown
    format raises; the blocking is checked."""
    arrs, kw = _inputs(2, 64 * 4, 64, True, seed=7)
    t = list(map(torch.from_numpy, arrs))
    sc = ref.scalar_stack(kw["lr"], B1, B2, EPS, WD, kw["c1"], kw["c2"])
    before = fused_update.adam8bit_store_update.launches
    ops.adam8bit_store_update(*t, block=64, **kw)
    assert fused_update.adam8bit_store_update.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fused_update.adam8bit_store_update(*t, sc, block=64)
    with pytest.raises(ValueError, match="uint8 row"):
        ops.adam8bit_store_update(*t[:6], t[6].float(), block=64, **kw)
    core = ops.adam8bit_store_update(*t, block=64, fmt="fp8_e4m3", **kw)[0]
    assert list(core) == ["codes", "master"]  # the fp8 epilogue, ported
    with pytest.raises(ValueError, match="unknown store fmt"):
        ops.adam8bit_store_update(*t, block=64, fmt="int4", **kw)
    with pytest.raises(ValueError, match="block == 0"):
        ops.adam8bit_store_update(*t, block=96, **kw)


# --------------------------------------------------------------------------- #
# the optimizer's contracts
# --------------------------------------------------------------------------- #
def _qwen_runtime(schedule=None, **cfg_kw):
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                              **cfg_kw)
    return cfg, FSDPRuntime(build_model(cfg), init_local_group("gloo"),
                            device="cpu", compute_dtype=torch.float32,
                            schedule=schedule)


def test_adam8bit_state_and_mask_rows():
    """The registry returns Adam8bit for qwen3-moe; its state has the
    reference's leaves and shapes, zero at init; the decay mask is one
    (S,) uint8 row per group, the rank's matrix mask (the same for every
    layer row)."""
    cfg, rt = _qwen_runtime()
    opt = make_optimizer(cfg)
    assert isinstance(opt, Adam8bit)
    state = opt.init(rt)
    assert list(state) == ["m8", "v8", "ms", "vs"]
    for name, lo in rt.layouts.items():
        shape = lo.local_shape()
        S = shape[-1]
        for k, dt, last in (("m8", torch.int8, S), ("v8", torch.int8, S),
                            ("ms", torch.float32, S // 64),
                            ("vs", torch.float32, S // 64)):
            t = state[k][name]
            assert t.dtype == dt and tuple(t.shape) == shape[:-1] + (last,)
            assert not t.any()
        mask = opt._masks[name]
        assert mask.dtype == torch.uint8 and tuple(mask.shape) == (S,)
        assert np.array_equal(mask.numpy(),
                              matrix_mask_local(lo, 0).astype(np.uint8))
        # the expert group holds matrices only; the others norms too
        assert (int(mask.sum()) == S) == (name == "layers_experts")


def test_adam8bit_shard_alignment_errors():
    """A shard not aligned to the optimizer's quant block, and a q8 store
    whose block differs from the optimizer's, raise as in the reference."""
    cfg, rt = _qwen_runtime()
    bad = Adam8bit(dataclasses.replace(cfg, quant_block=1 << 20))
    with pytest.raises(ValueError, match="not aligned to quant block"):
        bad.init(rt)
    cfg, rt = _qwen_runtime(CommSchedule(param_store="q8_block"))
    params = rt.init_params(0)
    other = Adam8bit(dataclasses.replace(cfg, quant_block=32))
    state = other.init(rt)
    grads = {n: torch.zeros_like(rt.layouts[n].store.trainable(s))
             for n, s in params.items()}
    with pytest.raises(ValueError, match="store quant block 64 != "
                                         "optimizer quant block 32"):
        other.update(rt, params, grads, state, 0)


# --------------------------------------------------------------------------- #
# the CUDA kernel against its plain version (BITWISE), on the card only
# --------------------------------------------------------------------------- #
# (rows, n, block, element offset): the vector path, a misaligned view
# (scalar path), an odd block (scalar path), a block staged above 48 KB
# (rows, S, block, element offset): the flat epilogue's warp kernel with
# 16-byte accesses (block 1024, and 256 with idle lanes), its element-wise
# path (block 64, 96, and block 1024 at an odd offset), and the CTA-per-block
# kernel (block 7, 8192)
CARD_CASES = [(2, 1024 * 96, 1024, 0), (3, 64 * 50, 64, 0),
              (2, 64 * 50, 64, 1), (2, 7 * 33, 7, 0), (1, 8192 * 3, 8192, 0),
              (1, 1024 * 40, 1024, 1), (2, 256 * 12, 256, 0),
              (2, 96 * 20, 96, 0)]


def _card_args(rows, n, block, offset, seed, first_step=False):
    """Card tensors at an element offset into their buffers; the decay
    mask is one (n,) row broadcast over the rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def view(x, dtype):
        buf = torch.empty(x.numel() + offset, dtype=dtype, device="cuda")
        buf[offset:] = x.reshape(-1).to(dtype)
        return buf[offset:].view(x.shape)

    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    w, g = rnd((rows, n), 0.05), rnd((rows, n), 1e-3)
    g[0, :block] = 0.0
    if first_step:
        m8 = torch.zeros((rows, n), dtype=torch.int8, device="cuda")
        ms = torch.zeros((rows, n // block), device="cuda")
        v8, vs = m8.clone(), ms.clone()
    else:
        m8, ms = ops.quantize(rnd((rows, n), 1e-4), block)
        v8, vs = ops.quantize_log(rnd((rows, n), 3e-4).square_(), block)
    mask = (torch.rand(n, generator=gen, device="cuda") < 0.8)
    return [view(w, torch.float32), view(g, torch.float32),
            view(m8, torch.int8), view(v8, torch.int8), ms, vs,
            view(mask, torch.uint8)]


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "q8_block"])
def test_adam8bit_kernel_matches_plain_on_card(fmt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kw = dict(lr=3e-4, b1=B1, b2=B2, eps=EPS, wd=WD, c1=1 - B1 ** 3,
              c2=1 - B2 ** 3)
    sc = ref.scalar_stack(*kw.values())
    wrapper = fused_update.adam8bit_q8_update if fmt == "q8_block" \
        else fused_update.adam8bit_store_update
    # the flat epilogues also with the train step's gradient scale, and the
    # bf16 store with its bf16 gradient
    grads = [(torch.float32, None)] + (
        [(torch.float32, 0.5)] if fmt == "fp32" else
        [(torch.bfloat16, None), (torch.bfloat16, 0.5)] if fmt == "bf16"
        else [])
    for (rows, n, block, offset), first, (g_dtype, scale) in \
            itertools.product(CARD_CASES, (True, False), grads):
        t = _card_args(rows, n, block, offset, seed=n + offset,
                       first_step=first)
        if fmt == "bf16":
            t[0] = t[0].to(torch.bfloat16)
        t[1] = t[1].to(g_dtype)
        gs = None if scale is None else torch.tensor(scale, device="cuda")
        before = wrapper.launches
        got = ops.adam8bit_store_update(*t, fmt=fmt, block=block,
                                        g_scale=gs, **kw)
        assert wrapper.launches == before + 1
        want = ref.adam8bit_store_update_ref(*t, sc, fmt, block, gs)
        torch.cuda.synchronize()
        case = (fmt, rows, n, block, offset, first, g_dtype, scale)
        if fmt == "q8_block":
            got = tuple(got[0][k] for k in ("codes", "master", "scales")) \
                + got[1:]
            want = tuple(want[0][k] for k in ("codes", "master",
                                              "scales")) + want[1:]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), case
        # in place on the state's tensors, as the optimizer runs it
        w, m8, v8, ms, vs = (x.clone() for x in (t[0], *t[2:6]))
        extra = (torch.empty_like(m8), w, torch.empty_like(ms)) \
            if fmt == "q8_block" else (w,)
        out = extra + (m8, v8, ms, vs)
        ops.adam8bit_store_update(w, t[1], m8, v8, ms, vs, t[6],
                                  fmt=fmt, block=block, out=out,
                                  g_scale=gs, **kw)
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert torch.equal(a, b), ("in place",) + case
