"""The fp8 and bf16 stores' pieces of the port against the JAX reference on
the CPU, and their CUDA kernels against their plain versions on the card.

Inputs come from numpy seeds; the reference runs its Pallas kernels in
interpret mode through ``repro.kernels.ops`` and ``repro.kernels.
fused_update``.  Parity classes, measured:
  * ``quant.fp8.fp8_encode`` vs ``astype(float8_*)``: BITWISE as uint8,
    NaN codes included, over every fp8 value and every rounding midpoint
    +-64 float32 ulps in both signs, the overflow boundaries and seeded
    normals (float32 inputs), and over all 65,536 bfloat16 bit patterns.
  * the fp8 epilogues of the fused updates (rows 8b, 9b): m', v' (8b) and
    the moments (9b) in the classes of the flat epilogues
    (tests/test_torch_kernels.py, tests/test_torch_adam8bit.py); the master
    w' likewise; the codes are BITWISE ``fp8_encode`` of the port's own w'
    and equal the reference's but where the two masters straddle an fp8
    rounding boundary (a code moves by one; ``CODE_FRAC`` bounds how
    often).
  * the standalone updates (rows 6, 7): the flat fp32 epilogues' classes.
  * the bf16 store's update (bf16 w and g, the gradient scale applied in
    fp32 inside the update) vs the reference's (bf16 w, the fp32 gradient
    ``g * scale``): w' within one bf16 step, m' and v' as the fp32
    epilogue's.
  * the fp8 cast reduce-scatter on 2 and 4 gloo ranks: BITWISE against
    XLA's ``psum_scatter`` on 4 host devices (which sums in float16 from +0
    in device order; an exact fp32 sum rounded once missed 27 of 4,096
    e4m3 shards' elements and 72 e5m2 on 4 devices, and the sign of 100
    zeros on 2).
  * stores, codecs, schedules and plans: BITWISE (metadata, encodes).
  * each CUDA kernel vs its plain version on the card: BITWISE (``gpu``).

The reference's modules are imported on first use (``_Lazy``): the card's
machine has no JAX and runs only this file's ``gpu`` tests.
"""
import importlib
import multiprocessing
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_fp8_worker as FW
from repro_torch.configs import build_model, get_config
from repro_torch.core import policy, schedule, store, wire
from repro_torch.kernels import fused_update, ops, ref
from repro_torch.quant import blockwise
from repro_torch.quant.fp8 import FP8_DTYPES, fp8_encode

torch.set_num_threads(2)


class _Lazy:
    """A module imported at its first attribute access."""

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jnp = _Lazy("jax.numpy")
jax_ops = _Lazy("repro.kernels.ops")
jax_policy = _Lazy("repro.core.policy")
jax_schedule = _Lazy("repro.core.schedule")
jax_store = _Lazy("repro.core.store")
jax_wire = _Lazy("repro.core.wire")
jax_configs = _Lazy("repro.configs")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FMTS = ("fp8_e4m3", "fp8_e5m2")


def _jdt(fmt):
    return {"fp8_e4m3": jnp.float8_e4m3fn, "fp8_e5m2": jnp.float8_e5m2}[fmt]


LR, B1, B2, EPS, WD = np.float32(3e-4), 0.9, 0.95, 1e-8, 0.1
# asserted bounds: w' in ulp of max(|w|, |w - w'|); fp8 codes differ (by one
# step) on at most CODE_FRAC of the elements; scales in integer-view steps
W_ULP, CODE_FRAC, SCALE_STEPS = 4, 1e-3, 2


def _u8(a):
    """Bit-pattern view: fp8 equality that sees NaN codes."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _iv(a):
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize]) \
        .astype(np.int64)


def _ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))).astype(np.float64)


def _kw(first_step):
    t = np.float32(1 if first_step else 3)
    return dict(lr=LR, b1=B1, b2=B2, eps=EPS, wd=WD,
                c1=np.float32(1) - np.float32(B1) ** t,
                c2=np.float32(1) - np.float32(B2) ** t)


def _sc(kw):
    return ref.scalar_stack(kw["lr"], B1, B2, EPS, WD, kw["c1"], kw["c2"])


# --------------------------------------------------------------------------- #
# the encode
# --------------------------------------------------------------------------- #
def _sweep(fmt):
    """Every finite fp8 value and every midpoint between neighbours, +-64
    float32 ulps around each, the overflow boundaries, +-inf, NaN and
    seeded normals at 1e-4 ... 1e3, in both signs."""
    allc = np.arange(256, dtype=np.uint8)
    vals = np.asarray(jnp.asarray(allc).view(_jdt(fmt)).astype(jnp.float32))
    fin = np.unique(vals[np.isfinite(vals)])
    mids = ((fin[:-1].astype(np.float64) + fin[1:]) / 2).astype(np.float32)
    bits = np.abs(np.concatenate([fin, mids]).view(np.int32))
    near = (bits[:, None] + np.arange(-64, 65, dtype=np.int32)).reshape(-1)
    near = near[near >= 0].view(np.float32)
    edges = np.array([448, 463.99, 464.0, 464.0001, 480, 1e4, 57344, 61439,
                      61440, np.inf, np.nan], np.float32)
    r = np.random.default_rng(0)
    normals = np.concatenate([r.standard_normal(20000) * s
                              for s in (1e-4, 1e-2, 1, 1e2, 1e3)])
    x = np.concatenate([near, edges, normals.astype(np.float32)])
    return np.concatenate([x, -x])


@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_encode_matches_reference(fmt):
    x = _sweep(fmt)
    want = _u8(jnp.asarray(x).astype(_jdt(fmt)))
    got = fp8_encode(torch.from_numpy(x), fmt)
    assert got.dtype == FP8_DTYPES[fmt] and got.shape == x.shape
    assert np.array_equal(_u8(got), want)


@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_encode_bf16_exhaustive(fmt):
    """All 65,536 bfloat16 bit patterns (e5m2 turns a bf16 NaN into 0x7f
    whatever its sign, as the reference does)."""
    bits = np.arange(65536, dtype=np.uint16)
    want = _u8(jnp.asarray(bits).view(jnp.bfloat16).astype(_jdt(fmt)))
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    assert np.array_equal(_u8(fp8_encode(x, fmt)), want)


def test_fp8_encode_boundaries():
    """The reference's overflow rule, value by value: e4m3 keeps 464.0
    (the tie rounds to 448, 0x7e) and turns 464.0001, inf and NaN into NaN
    with the sign; e5m2 keeps 61439 (57344) and turns 61440 into inf."""
    x = torch.tensor([464.0, 464.0001, -464.0001, float("inf"),
                      float("-inf"), float("nan"), 61439.0, 61440.0,
                      -61440.0, 2.0 ** -9, 2.0 ** -10, 2.0 ** -17])
    assert _u8(fp8_encode(x, "fp8_e4m3")).tolist() == [
        0x7E, 0x7F, 0xFF, 0x7F, 0xFF, 0x7F, 0x7F, 0x7F, 0xFF, 0x01, 0x00,
        0x00]
    assert _u8(fp8_encode(x, "fp8_e5m2")).tolist() == [
        0x5F, 0x5F, 0xDF, 0x7C, 0xFC, 0x7E, 0x7B, 0x7C, 0xFC, 0x18, 0x14,
        0x00]
    with pytest.raises(ValueError, match="fp8 format"):
        fp8_encode(x, "fp8_e3m4")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fp8_encode(x.double(), "fp8_e4m3")


# --------------------------------------------------------------------------- #
# rows 8b and 6: the AdamW fp8 epilogue and the standalone AdamW
# --------------------------------------------------------------------------- #
def _adamw_inputs(n, first_step, seed, scale=0.05):
    r = np.random.default_rng(seed)
    w = (r.standard_normal(n) * scale).astype(np.float32)
    g = (r.standard_normal(n) * 1e-3).astype(np.float32)
    if first_step:
        m = np.zeros(n, np.float32)
        v = np.zeros(n, np.float32)
    else:
        m = (r.standard_normal(n) * 1e-4).astype(np.float32)
        v = np.abs(r.standard_normal(n) * 1e-7).astype(np.float32)
    mask = (r.random(n) < 0.8).astype(np.float32)
    return (w, g, m, v, mask), _kw(first_step)


def _check_adamw(w, g, kw, tw, tm, tv, jw, jm, jv, first_step):
    """The flat epilogue's class (tests/test_torch_kernels.py)."""
    f64 = np.float64
    tw, tm, tv, jw, jm, jv = (np.asarray(a) for a in (tw, tm, tv, jw, jm,
                                                      jv))
    if first_step:
        assert np.array_equal(_iv(tm), _iv(jm))
        assert np.array_equal(_iv(tv), _iv(jv))
        dupd = 0.0
    else:
        term = (np.float32(1) - np.float32(B1)) * g
        assert np.all(np.abs(f64(tm) - f64(jm)) <= _ulp(term) + _ulp(tm))
        assert np.all(np.abs(f64(tv) - f64(jv)) <= _ulp(tv))
        dupd = np.abs(f64(tm) - f64(jm)) / f64(kw["c1"]) / (
            np.sqrt(f64(tv) / f64(kw["c2"])) + EPS)
    step = np.abs(f64(w) - f64(tw))
    bound = f64(LR) * dupd + W_ULP * _ulp(np.maximum(np.abs(w), step))
    assert np.all(np.abs(f64(tw) - f64(jw)) <= bound)


def _check_codes(fmt, tcodes, tmaster, jcodes):
    """Codes: bitwise the encode of the port's own master; against the
    reference's at most one fp8 step apart, on few elements."""
    assert np.array_equal(_u8(tcodes), _u8(fp8_encode(tmaster, fmt)))
    a = _u8(tcodes).astype(np.int64)
    b = _u8(jcodes).astype(np.int64)
    d = np.abs(a - b)
    assert d.max() <= 1
    assert np.count_nonzero(d) <= CODE_FRAC * d.size


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("first_step", [True, False],
                         ids=["zero_moments", "moments"])
def test_adamw_fp8_plain_matches_reference(fmt, first_step):
    """Row 8b on a ragged length (no lane tail: the port takes any n).
    Weights at scale 100 so that e4m3 sees masters past its overflow
    boundary.  Measured: codes bitwise the reference's (0 of 300,007
    differ), w' within 1 ulp, m' and v' in the flat epilogue's class."""
    arrs, kw = _adamw_inputs(300_007, first_step, seed=11, scale=100.0)
    jcore, jm, jv = jax_ops.adamw_store_update(*map(jnp.asarray, arrs),
                                               fmt=fmt, **kw)
    tcore, tm, tv = ops.adamw_store_update(*map(torch.from_numpy, arrs),
                                           fmt=fmt, **kw)
    assert list(tcore) == list(jcore) == ["codes", "master"]
    assert tcore["codes"].dtype == FP8_DTYPES[fmt]
    _check_adamw(arrs[0], arrs[1], kw, tcore["master"], tm, tv,
                 jcore["master"], jm, jv, first_step)
    _check_codes(fmt, tcore["codes"], tcore["master"], jcore["codes"])


@pytest.mark.parametrize("first_step", [True, False],
                         ids=["zero_moments", "moments"])
def test_adamw_update_plain_matches_reference(first_step):
    """Row 6 (the standalone ``adamw_update``, n % 128 == 0): the fp32
    epilogue's class; n % 128 != 0 raises on both sides."""
    arrs, kw = _adamw_inputs(128 * 1531, first_step, seed=12)
    jw, jm, jv = jax_ops.adamw_update(*map(jnp.asarray, arrs), **kw)
    tw, tm, tv = ops.adamw_update(*map(torch.from_numpy, arrs), **kw)
    assert tw.dtype == tm.dtype == tv.dtype == torch.float32
    _check_adamw(arrs[0], arrs[1], kw, tw, tm, tv, jw, jm, jv, first_step)
    bad = [torch.from_numpy(a[:1000]) for a in arrs]
    with pytest.raises(ValueError, match="128"):
        ops.adamw_update(*bad, **kw)


def test_bf16_store_adamw_matches_reference():
    """The bf16 store's update: the port hands the kernel the bf16 buffer,
    the bf16 gradient and the train step's scale (1/504, not a power of
    two); the reference the bf16 buffer and the fp32 gradient ``g *
    scale``.  w' within one bf16 step, m' and v' in the fp32 class."""
    arrs, kw = _adamw_inputs(200_003, False, seed=13)
    w, g, m, v, mask = arrs
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    gb = jnp.asarray(g * 504).astype(jnp.bfloat16)
    scale = np.float32(1) / np.float32(504)
    jg = gb.astype(jnp.float32) * scale
    jw2, jm, jv = jax_ops.adamw_store_update(
        wb, jg, *map(jnp.asarray, (m, v, mask)), fmt="bf16", **kw)
    tw = torch.from_numpy(np.asarray(wb.astype(jnp.float32))).bfloat16()
    tg = torch.from_numpy(np.asarray(gb.astype(jnp.float32))).bfloat16()
    tw2, tm, tv = ops.adamw_store_update(
        tw, tg, *map(torch.from_numpy, (m, v, mask)), fmt="bf16",
        g_scale=torch.tensor(scale), **kw)
    assert tw2.dtype == torch.bfloat16
    f64 = np.float64
    gf = np.asarray(jg)
    term = (np.float32(1) - np.float32(B1)) * gf
    assert np.all(np.abs(f64(tm.numpy()) - f64(np.asarray(jm)))
                  <= _ulp(term) + _ulp(tm.numpy()))
    assert np.all(np.abs(f64(tv.numpy()) - f64(np.asarray(jv)))
                  <= _ulp(tv.numpy()))
    a = _iv(np.asarray(jw2.astype(jnp.float32))) >> 16
    b = _iv(tw2.float().numpy()) >> 16
    assert np.abs(a - b).max() <= 1


# --------------------------------------------------------------------------- #
# rows 9b and 7: the 8-bit Adam fp8 epilogue and the standalone 8-bit Adam
# --------------------------------------------------------------------------- #
def _adam8_inputs(rows, n, block, first_step, seed, scale=0.05,
                  codecs="reference"):
    """Weights, gradients at per-block magnitudes from 5e-5 to 2e-2, the
    int8 moments through the reference's codecs (or the port's, on the
    card), one uint8 decay row."""
    jb = importlib.import_module("repro.quant.blockwise") \
        if codecs == "reference" else None
    r = np.random.default_rng(seed)
    w = (r.standard_normal((rows, n)) * scale).astype(np.float32)
    mag = np.exp(r.uniform(-3, 3, (rows, n // block, 1)))
    g = (r.standard_normal((rows, n // block, block)) * 1e-3 * mag) \
        .reshape(rows, n).astype(np.float32)
    if first_step:
        z8 = np.zeros((rows, n), np.int8)
        zs = np.zeros((rows, n // block), np.float32)
        m8, v8, ms, vs = z8, z8.copy(), zs, zs.copy()
    else:
        m = (r.standard_normal((rows, n)) * 1e-4).astype(np.float32)
        v = np.abs(r.standard_normal((rows, n)) * 1e-7).astype(np.float32)
        if jb is None:
            m8, ms = (a.numpy() for a in blockwise.quantize_blockwise(
                torch.from_numpy(m), block))
            v8, vs = (a.numpy() for a in blockwise.quantize_blockwise_log(
                torch.from_numpy(v), block))
        else:
            m8, ms = (np.asarray(a) for a in jb.quantize_blockwise(
                jnp.asarray(m), block))
            v8, vs = (np.asarray(a) for a in jb.quantize_blockwise_log(
                jnp.asarray(v), block))
    mask = (r.random(n) < 0.8).astype(np.uint8)
    return (w, g, m8, v8, ms, vs, mask), _kw(first_step)


def _check_moments(tout, jout):
    for a, b in zip(tout, jout):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == np.int8:
            d = np.abs(a.astype(np.int64) - b)
            assert d.max() <= 1 and np.count_nonzero(d) <= CODE_FRAC * d.size
        else:
            assert np.abs(_iv(a) - _iv(b)).max() <= SCALE_STEPS


def _check_master(w, tw2, jw2):
    step = np.abs(w.astype(np.float64) - tw2)
    bound = W_ULP * _ulp(np.maximum(np.abs(w), step))
    assert np.all(np.abs(tw2.astype(np.float64) - jw2) <= bound)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("first_step", [True, False],
                         ids=["zero_moments", "moments"])
def test_adam8bit_fp8_plain_matches_reference(fmt, first_step):
    """Row 9b, three rows of block-64 quant blocks, weights at scale 100.
    Measured: codes bitwise the reference's (0 of 61,440 differ), w'
    within 1 ulp, moment codes bitwise, ms' within 2 and vs' within 1
    integer-view step."""
    arrs, kw = _adam8_inputs(3, 64 * 320, 64, first_step, seed=21,
                             scale=100.0)
    w, g, m8, v8, ms, vs, mask = arrs
    full = np.broadcast_to(mask.astype(np.float32), w.shape)
    jout = jax_ops.adam8bit_store_update(
        *map(jnp.asarray, (w, g, m8, v8, ms, vs, full)), fmt=fmt, block=64,
        **kw)
    tout = ops.adam8bit_store_update(*map(torch.from_numpy, arrs), fmt=fmt,
                                     block=64, **kw)
    tcore, jcore = tout[0], jout[0]
    assert list(tcore) == list(jcore) == ["codes", "master"]
    _check_moments([a.numpy() for a in tout[1:]], jout[1:])
    _check_master(w, tcore["master"].numpy(), np.asarray(jcore["master"]))
    _check_codes(fmt, tcore["codes"], tcore["master"], jcore["codes"])


@pytest.mark.parametrize("first_step", [True, False],
                         ids=["zero_moments", "moments"])
def test_adam8bit_update_plain_matches_reference(first_step):
    """Row 7 (the standalone ``adam8bit_update``: flat fp32 w and g, a
    full-size fp32 mask with values other than 0 and 1): the flat
    epilogue's class.  Measured: w' within 2 ulp (zero moments) and 4 ulp
    (moments), moment codes bitwise, scales within 1 integer-view step."""
    arrs, kw = _adam8_inputs(1, 1024 * 24, 1024, first_step, seed=22)
    w, g, m8, v8, ms, vs, _ = (a.reshape(-1) for a in arrs)
    mask = np.random.default_rng(5).random(w.size).astype(np.float32)
    jout = jax_ops.adam8bit_update(*map(jnp.asarray, (w, g, m8, v8, ms, vs,
                                                      mask)), block=1024, **kw)
    tout = ops.adam8bit_update(*map(torch.from_numpy, (w, g, m8, v8, ms, vs,
                                                       mask)), block=1024,
                               **kw)
    assert [tuple(t.shape) for t in tout] == [a.shape for a in jout]
    _check_moments([a.numpy() for a in tout[1:]], jout[1:])
    _check_master(w, tout[0].numpy(), np.asarray(jout[0]))
    with pytest.raises(ValueError, match="block"):
        ops.adam8bit_update(*map(torch.from_numpy, (w, g, m8, v8, ms, vs,
                                                    mask)), block=1000, **kw)


def test_bf16_store_adam8bit_matches_reference():
    """The bf16 store under 8-bit Adam: bf16 w and g with the scale in the
    update against the reference's bf16 w and fp32 ``g * scale``."""
    arrs, kw = _adam8_inputs(2, 64 * 100, 64, False, seed=23)
    w, g, m8, v8, ms, vs, mask = arrs
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    gb = jnp.asarray(g * 504).astype(jnp.bfloat16)
    scale = np.float32(1) / np.float32(504)
    full = np.broadcast_to(mask.astype(np.float32), w.shape)
    jout = jax_ops.adam8bit_store_update(
        wb, gb.astype(jnp.float32) * scale,
        *map(jnp.asarray, (m8, v8, ms, vs, full)), fmt="bf16", block=64,
        **kw)
    tout = ops.adam8bit_store_update(
        torch.from_numpy(np.asarray(wb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(np.asarray(gb.astype(jnp.float32))).bfloat16(),
        *map(torch.from_numpy, (m8, v8, ms, vs, mask)), fmt="bf16",
        block=64, g_scale=torch.tensor(scale), **kw)
    assert tout[0].dtype == torch.bfloat16
    _check_moments([a.numpy() for a in tout[1:]], jout[1:])
    a = _iv(np.asarray(jout[0].astype(jnp.float32))) >> 16
    b = _iv(tout[0].float().numpy()) >> 16
    assert np.abs(a - b).max() <= 1


def test_fp8_out_in_place_on_cpu():
    """``out=`` the state's own tensors, as the optimizers run it."""
    arrs, kw = _adamw_inputs(5000, False, seed=14)
    w, g, m, v, mask = (torch.from_numpy(a.copy()) for a in arrs)
    want = ops.adamw_store_update(w.clone(), g, m.clone(), v.clone(), mask,
                                  fmt="fp8_e5m2", **kw)
    codes = torch.empty_like(w, dtype=torch.float8_e5m2)
    core, m2, v2 = ops.adamw_store_update(w, g, m, v, mask, fmt="fp8_e5m2",
                                          out=(codes, w, m, v), **kw)
    assert core["codes"] is codes and core["master"] is w and m2 is m
    assert np.array_equal(_u8(codes), _u8(want[0]["codes"]))
    assert torch.equal(w, want[0]["master"]) and torch.equal(m, want[1])


def test_kernel_wrappers_reject_cpu_tensors():
    """The new wrappers never compute on the CPU: they raise before any
    build or launch."""
    arrs, kw = _adamw_inputs(256, True, seed=1)
    t = [torch.from_numpy(a) for a in arrs]
    with pytest.raises(ValueError, match="CUDA"):
        fused_update.adamw_update(*t, _sc(kw))
    with pytest.raises(ValueError, match="CUDA"):
        fused_update.adamw_store_update(*t, _sc(kw), fmt="fp8_e4m3")
    a8, kw8 = _adam8_inputs(1, 64 * 4, 64, True, seed=2)
    t8 = [torch.from_numpy(a) for a in a8]
    with pytest.raises(ValueError, match="CUDA"):
        fused_update.adam8bit_store_update(*t8, _sc(kw8), block=64,
                                           fmt="fp8_e5m2")
    with pytest.raises(ValueError, match="CUDA"):
        fused_update.adam8bit_update(*t8[:6], t8[0], _sc(kw8), block=64)


# --------------------------------------------------------------------------- #
# the fp8 cast reduce-scatter: gloo ranks vs XLA's psum_scatter
# --------------------------------------------------------------------------- #
_XLA_REDUCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, sys.argv[1])
    from repro.compat import make_mesh, shard_map
    from repro.core.wire import WireCodec, codec_reduce_scatter
    out = {}
    for world in (2, 4):
        mesh = make_mesh((world,), ("data",), devices=jax.devices()[:world])
        x = np.load(sys.argv[2])[f"x{world}"]
        for fmt in ("fp8_e4m3", "fp8_e5m2"):
            def f(ct, fmt=fmt, world=world):
                shard, _ = codec_reduce_scatter(
                    ct[0], None, WireCodec(fmt), ("data",), (world,), "xla",
                    "match", jnp.float32)
                return shard[None]
            y = jax.jit(shard_map(f, mesh=mesh, in_specs=P("data"),
                                  out_specs=P("data")))(x)
            out[f"{fmt}_{world}"] = np.asarray(y)
    np.savez(sys.argv[3], **out)
""")
RS_N = 4096


@pytest.fixture(scope="module")
def xla_reduce(tmp_path_factory):
    d = tmp_path_factory.mktemp("xla_rs")
    np.savez(d / "in.npz", **{f"x{w}": FW.inputs(w, RS_N) for w in (2, 4)})
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run([sys.executable, "-c", _XLA_REDUCE,
                    os.path.join(ROOT, "src"), str(d / "in.npz"),
                    str(d / "out.npz")], check=True, env=env, timeout=300)
    return dict(np.load(d / "out.npz"))


def _same_floats(a, b):
    """Bitwise where not NaN; NaN at the same places with the same sign."""
    a, b = np.asarray(a), np.asarray(b)
    na, nb = np.isnan(a), np.isnan(b)
    assert np.array_equal(na, nb)
    assert np.array_equal(np.signbit(a), np.signbit(b))
    assert np.array_equal(a[~na].view(np.int32), b[~nb].view(np.int32))


@pytest.mark.parametrize("world", [2, 4])
def test_fp8_reduce_scatter_matches_xla(world, xla_reduce, tmp_path):
    """``world`` gloo ranks run the port's fp8 route (codes un-reduced to
    their destination, summed in float16 from +0 in rank order, encoded
    once); every rank's shard equals XLA's 4-host-device ``psum_scatter``
    of the same payloads bitwise, in both formats (e4m3 sums past 464 are
    NaN on both sides)."""
    ctx = multiprocessing.get_context("spawn")
    prefix = str(tmp_path / "rank")
    procs = [ctx.Process(target=FW.reduce_rank_main,
                         args=(r, world, str(tmp_path / "store"), prefix,
                               RS_N))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks {alive} did not finish"
    assert [p.exitcode for p in procs] == [0] * world
    for fmt in FMTS:
        want = xla_reduce[f"{fmt}_{world}"]
        for r in range(world):
            got = np.load(f"{prefix}{r}.npz")[fmt]
            assert got.shape == (RS_N // world,)
            _same_floats(got, want[r])
    assert np.isnan(xla_reduce[f"fp8_e4m3_{world}"]).any()
    if world == 4:
        # the rule is the float16 sum: an exact fp32 sum rounded once to
        # fp8 misses XLA (measured: 27 e4m3 and 72 e5m2 of 4,096 elements)
        x = FW.inputs(world, RS_N)
        for fmt in FMTS:
            dec = fp8_encode(torch.from_numpy(x), fmt).float()
            total = dec[0].clone()
            for j in range(1, world):
                total += dec[j]
            exact = fp8_encode(total, fmt).float().numpy()
            want = xla_reduce[f"{fmt}_{world}"].reshape(-1)
            same = (exact.view(np.int32) == want.view(np.int32)) | (
                np.isnan(exact) & np.isnan(want))
            assert not same.all(), fmt


def test_fp8_reduce_scatter_one_rank():
    """One rank: the fp8 round trip of the cotangent, as the reference's
    size-1 reduce-scatter."""
    from repro_torch.launch.mesh import init_local_group

    group = init_local_group("gloo")
    x = FW.inputs(2, RS_N)[0]
    for fmt in FMTS:
        got = wire.codec_reduce_scatter(torch.from_numpy(x), None,
                                        wire.WireCodec(fmt), group,
                                        torch.float32)
        want = np.asarray(jnp.asarray(x).astype(_jdt(fmt))
                          .astype(jnp.float32))
        _same_floats(got.numpy(), want)


# --------------------------------------------------------------------------- #
# stores, codecs, schedules, plans
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_store_structure(fmt):
    """The counterpart of the reference's ``test_fp8_state_structure``: the
    store's properties equal the reference's, ``create`` encodes the master
    bitwise as the reference's, trainable/frozen/combine round-trip."""
    s, js = store.ParamStore(fmt), jax_store.ParamStore(fmt)
    assert s.fp8 and not s.quantized and js.fp8
    assert s.state_keys() == js.state_keys() == ("codes", "master")
    assert s.leaf_dtype("codes") == s.fp8_dtype == FP8_DTYPES[fmt]
    assert s.leaf_dtype("master") == torch.float32
    assert s.align() == js.align() == 1
    assert s.wire_bytes(1000, torch.float32) == \
        js.wire_bytes(1000, np.float32) == 1000
    master = np.linspace(-500, 500, 6400, dtype=np.float32)
    state = s.create(torch.from_numpy(master).requires_grad_())
    jstate = js.create(master)
    assert list(state) == ["codes", "master"]
    assert np.array_equal(_u8(state["codes"]), _u8(jstate["codes"]))
    assert state["master"].requires_grad
    assert not state["codes"].requires_grad
    tr, fz = s.trainable(state), s.frozen(state)
    assert tr is state["master"] and list(fz) == ["codes"]
    back = s.combine(tr, fz)
    assert all(back[k] is state[k] for k in state)
    with pytest.raises(ValueError, match="fp8_dtype"):
        store.ParamStore("fp32").fp8_dtype
    ef = store.ParamStore(fmt, ef_m=2)
    assert ef.state_keys() == js.__class__(fmt, ef_m=2).state_keys()
    assert ef.align() == 1024


def test_bf16_store_structure():
    """The bf16 store: a bare bf16 leaf that requires grad, the round to
    nearest even of the master (bitwise the reference's ``create``)."""
    s, js = store.ParamStore("bf16"), jax_store.ParamStore("bf16")
    assert s.state_keys() is js.state_keys() is None
    assert s.storage_dtype == torch.bfloat16 and s.align() == 1
    assert s.wire_bytes(10, torch.bfloat16) == 20
    master = np.random.default_rng(0).standard_normal(4096).astype(
        np.float32)
    state = s.create(torch.from_numpy(master).requires_grad_())
    assert state.dtype == torch.bfloat16 and state.is_leaf
    assert state.requires_grad
    want = np.asarray(jnp.asarray(js.create(master)).astype(jnp.float32))
    assert np.array_equal(state.float().detach().numpy(), want)
    with_ef = store.ParamStore("bf16", ef_m=1)
    assert with_ef.leaf_dtype("master") == torch.bfloat16
    assert with_ef.state_keys() == ("master", "reduce_ef")


@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_wire_codec_matches_reference(fmt):
    got, want = wire.WireCodec(fmt), jax_wire.WireCodec(fmt)
    assert got.fp8 and not got.quantized
    assert got.wire_bytes(4096) == want.wire_bytes(4096) == 4096
    x = _sweep(fmt)[:50_000]
    enc = got.encode(torch.from_numpy(x))
    assert np.array_equal(_u8(enc), _u8(want.encode(jnp.asarray(x))))
    dec = got.decode(enc, torch.bfloat16)
    jdec = want.decode(want.encode(jnp.asarray(x)), jnp.bfloat16)
    _same_floats(dec.float().numpy(), np.asarray(jdec.astype(jnp.float32)))


FP8_SCHEDULES = {
    "fp8_store": dict(param_store="fp8_e4m3"),
    "fp8_e5m2_store_q8_reduce": dict(param_store="fp8_e5m2",
                                     reduce_wire="q8_block"),
    "bf16_store": dict(param_store="bf16"),
    "fp8_gather": dict(gather_dtype="fp8_e4m3"),
    "fp8_reduce_dtype": dict(reduce_dtype="fp8_e5m2"),
    "fp8_reduce_wire": dict(reduce_wire="fp8_e4m3"),
}


@pytest.mark.parametrize("name", list(FP8_SCHEDULES))
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_fp8_schedule_codecs_match_reference(name, compute):
    want = jax_schedule.CommSchedule(**FP8_SCHEDULES[name])
    got = schedule.CommSchedule(**FP8_SCHEDULES[name])
    jdt, tdt = ((jnp.float32, torch.float32) if compute == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    assert str(got.accum_dtype(tdt)).split(".")[-1] == \
        str(want.accum_dtype(jdt))
    assert str(got.wire_dtype(tdt)).split(".")[-1] == \
        str(want.wire_dtype(jdt))
    rc, jrc = got.reduce_codec(tdt, 64), want.reduce_codec(jdt, 64)
    assert (rc.fmt, rc.block) == (jrc.fmt, jrc.block)
    assert got.gather_codec(tdt).fmt == want.gather_codec(jdt).fmt
    assert got.ef_enabled == want.ef_enabled
    got.validate_for(tdt)
    want.validate_for(jdt)


@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_store_fixes_the_gather_payload(fmt):
    """``validate_for`` refuses a gather dtype beside an fp8 store, with
    the reference's ValueError."""
    kw = dict(param_store=fmt, gather_dtype="bf16")
    with pytest.raises(ValueError, match="gather_dtype") as got:
        schedule.CommSchedule(**kw).validate_for(torch.bfloat16)
    with pytest.raises(ValueError, match="gather_dtype") as want:
        jax_schedule.CommSchedule(**kw).validate_for(jnp.bfloat16)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown schedule dtype"):
        schedule.CommSchedule(gather_dtype="fp8_e3m4")


@pytest.mark.parametrize("store_fmt", ["fp32", "bf16", "fp8_e4m3",
                                       "fp8_e5m2", "q8_block"])
@pytest.mark.parametrize("data", [1, 2])
def test_plan_param_bytes_match_reference(store_fmt, data):
    """Stored bytes per rank of every group (2 B/element for bf16, 5 for
    fp8, plus the q8 reduce wire's residual) equal the reference's."""
    sched = dict(param_store=store_fmt, reduce_wire="q8_block")
    cfg, jcfg = get_config("gemma2-2b").reduced(), \
        jax_configs.get_config("gemma2-2b").reduced()
    got = policy.plan(build_model(cfg), {"data": data, "model": 1},
                      schedule.CommSchedule(**sched))
    want = jax_policy.make_plan(jax_configs.build_model(jcfg),
                                {"data": data, "model": 1},
                                jax_schedule.CommSchedule(**sched))
    for name, e in got.groups.items():
        assert e.param_bytes() == want.groups[name].param_bytes(), name
        assert e.store.leaf_dtype("master") == (
            torch.bfloat16 if store_fmt == "bf16" else torch.float32)


# --------------------------------------------------------------------------- #
# the card: each kernel against its plain version (BITWISE)
# --------------------------------------------------------------------------- #
def _cuda(arrs, offset=0):
    """Card tensors ``offset`` elements into their buffers (an odd offset
    takes the scalar path)."""
    out = []
    for a in arrs:
        buf = torch.empty(a.size + offset, dtype=torch.from_numpy(a).dtype,
                          device="cuda")
        buf[offset:] = torch.from_numpy(np.ascontiguousarray(a)).reshape(-1) \
            .cuda()
        out.append(buf[offset:].view(a.shape))
    return out


def _equal(a, b):
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if a.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS)
def test_adamw_fp8_kernel_matches_plain_on_card(fmt):
    _need_card()
    for n, offset in ((1024 * 128, 0), (300_007, 0), (4096, 1)):
        arrs, kw = _adamw_inputs(n, False, seed=n, scale=100.0)
        t = _cuda(arrs, offset)
        before = fused_update.adamw_fp8_update.launches
        got = ops.adamw_store_update(*t, fmt=fmt, **kw)
        assert fused_update.adamw_fp8_update.launches == before + 1
        want = ref.adamw_store_update_ref(*t, _sc(kw), fmt)
        torch.cuda.synchronize()
        assert all(_equal(a, b) for a, b in zip(got, want)), (n, offset)
        w, m, v = (x.clone() for x in (t[0], t[2], t[3]))
        codes = torch.empty_like(w, dtype=FP8_DTYPES[fmt])
        ops.adamw_store_update(w, t[1], m, v, t[4], fmt=fmt,
                               out=(codes, w, m, v), **kw)
        torch.cuda.synchronize()
        assert _equal({"codes": codes, "master": w}, want[0])


@pytest.mark.gpu
def test_fp8_boundaries_on_card():
    """The epilogue's encode at the overflow boundaries: masters that land
    on 464.0, 464.0001, 61439, 61440 and fp8 subnormals (lr 0, so every
    finite w' = w) get the reference's codes; inf and NaN inputs turn NaN
    through ``0 * inf`` (the card's NaN is positive) and get a NaN code;
    every code is the encode of its master."""
    _need_card()
    vals = np.array([448, 463.99, 464.0, 464.0001, 480, 1e4, 57344, 61439,
                     61440, np.inf, np.nan, 2.0 ** -9, 2.0 ** -10,
                     3 * 2.0 ** -11, 2.0 ** -16, 2.0 ** -17], np.float32)
    w = np.concatenate([vals, -vals] * 4)
    fin = np.isfinite(w)
    z = np.zeros_like(w)
    kw = dict(_kw(True), lr=np.float32(0))
    for fmt in FMTS:
        t = _cuda((w, z, z, z, z))
        core, _, _ = ops.adamw_store_update(*t, fmt=fmt, **kw)
        torch.cuda.synchronize()
        master, codes = core["master"].cpu(), _u8(core["codes"].cpu())
        assert np.array_equal(master.numpy()[fin], w[fin])
        assert np.array_equal(codes, _u8(fp8_encode(master, fmt)))
        want = _u8(fp8_encode(torch.from_numpy(w), fmt))
        assert np.array_equal(codes[fin], want[fin]), fmt
        nan_code = 0x7F if fmt == "fp8_e4m3" else 0x7E
        assert np.all(codes[~fin] & 0x7F == nan_code), fmt


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
def test_bf16_input_kernels_match_plain_on_card(fmt):
    """The bf16 store's passes: bf16 w and g with a gradient scale (8a
    with fmt bf16, 9a), and bf16 g on the fp32 epilogue."""
    _need_card()
    arrs, kw = _adamw_inputs(300_004, False, seed=31)
    t = _cuda(arrs)
    wb = t[0].bfloat16() if fmt == "bf16" else t[0]
    gb = t[1].mul(504).bfloat16()
    scale = torch.tensor(1 / 504, dtype=torch.float32, device="cuda")
    got = ops.adamw_store_update(wb, gb, t[2], t[3], t[4], fmt=fmt,
                                 g_scale=scale, **kw)
    want = ref.adamw_store_update_ref(wb, gb, t[2], t[3], t[4], _sc(kw), fmt,
                                      g_scale=scale)
    torch.cuda.synchronize()
    assert all(_equal(a, b) for a, b in zip(got, want))
    a8, kw8 = _adam8_inputs(2, 1024 * 64, 1024, False, seed=32,
                            codecs="port")
    t8 = _cuda(a8)
    w8 = t8[0].bfloat16() if fmt == "bf16" else t8[0]
    g8 = t8[1].mul(504).bfloat16()
    got = ops.adam8bit_store_update(w8, g8, *t8[2:], fmt=fmt, block=1024,
                                    g_scale=scale, **kw8)
    want = ref.adam8bit_store_update_ref(w8, g8, *t8[2:], _sc(kw8), fmt, 1024,
                                         g_scale=scale)
    torch.cuda.synchronize()
    assert all(_equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS)
def test_adam8bit_fp8_kernel_matches_plain_on_card(fmt):
    _need_card()
    for rows, n, block, offset in ((1, 1024 * 96, 1024, 0),
                                   (3, 64 * 50, 64, 0), (2, 64 * 50, 64, 1)):
        arrs, kw = _adam8_inputs(rows, n, block, False, seed=n, scale=100.0,
                                 codecs="port")
        t = _cuda(arrs, offset)
        before = fused_update.adam8bit_fp8_update.launches
        got = ops.adam8bit_store_update(*t, fmt=fmt, block=block, **kw)
        assert fused_update.adam8bit_fp8_update.launches == before + 1
        want = ref.adam8bit_store_update_ref(*t, _sc(kw), fmt, block)
        torch.cuda.synchronize()
        assert all(_equal(a, b) for a, b in zip(got, want)), (rows, n)


@pytest.mark.gpu
def test_standalone_kernels_match_plain_on_card():
    """Rows 6 and 7 through ``ops`` on the card, each counted apart."""
    _need_card()
    arrs, kw = _adamw_inputs(128 * 4099, False, seed=41)
    t = _cuda(arrs)
    before = fused_update.adamw_update.launches
    got = ops.adamw_update(*t, **kw)
    assert fused_update.adamw_update.launches == before + 1
    want = ref.adamw_update_ref(*t, _sc(kw))
    torch.cuda.synchronize()
    assert all(_equal(a, b) for a, b in zip(got, want))
    a8, kw8 = _adam8_inputs(1, 1024 * 50, 1024, False, seed=42,
                            codecs="port")
    w, g, m8, v8, ms, vs, _ = (a.reshape(-1) for a in a8)
    mask = np.random.default_rng(6).random(w.size).astype(np.float32)
    t8 = _cuda((w, g, m8, v8, ms, vs, mask))
    before = fused_update.adam8bit_update.launches
    got = ops.adam8bit_update(*t8, block=1024, **kw8)
    assert fused_update.adam8bit_update.launches == before + 1
    want = ref.adam8bit_update_ref(*t8, _sc(kw8), 1024)
    torch.cuda.synchronize()
    assert all(_equal(a, b) for a, b in zip(got, want))
