"""Block-wise quantized training of the port against the JAX reference on
the CPU: the plain versions of the four q8 kernels, the q8 store and wire
objects, the q8 reduce-scatter over two gloo ranks.

Inputs come from numpy seeds; the reference runs its Pallas kernels in
interpret mode through ``repro.kernels.ops``.  Parity classes, measured:
  * quantize: codes BITWISE; scales BITWISE except where the scale is
    subnormal (absmax < 127 * 2**-126), which XLA:CPU flushes to 0 and the
    port keeps -- those blocks' codes are 0 on both sides.
  * dequantize_into (fp32 and bf16 out): BITWISE.
  * encode_ef: codes and scales BITWISE; XLA contracts ``comp -
    codes*scale`` into one FMA (checked exactly below), the port rounds the
    product first, so new_ef differs by at most half an ulp of codes*scale
    plus one ulp of new_ef.
  * the q8 AdamW epilogue: m', v' and the master as the flat epilogue
    (tests/test_torch_kernels.py); the codes and scales are each side's
    quantize of its own master, so a scale moves with its block's absmax
    and a code by at most one.
  * the match-mode q8 reduce-scatter on two ranks: the shard BITWISE
    against the reference's kernels composed in rank order.
"""
import multiprocessing

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import schedule as jax_schedule
from repro.core import store as jax_store
from repro.core import wire as jax_wire
from repro.kernels import ops as jax_ops
from repro.quant import blockwise as jax_blockwise

import _torch_q8_worker as QW
from repro_torch.core import schedule, store, wire
from repro_torch.kernels import ops, ref
from repro_torch.quant import blockwise

torch.set_num_threads(2)

SUBNORMAL = np.float32(2.0 ** -126)
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1


def _x(rows, n, block, seed, dtype=np.float32):
    """Rows of blocks at scales from 1e-3 to 10, one all-zero block and two
    blocks whose absmax gives a subnormal scale."""
    r = np.random.default_rng(seed)
    nb = n // block
    x = r.standard_normal((rows, nb, block)) * \
        np.exp(r.uniform(np.log(1e-3), np.log(10.0), (rows, nb, 1)))
    x[0, 0] = 0.0
    if nb > 2:
        x[-1, 1] = r.standard_normal(block) * 1e-41   # subnormal inputs
        x[-1, 2] = r.standard_normal(block) * 3e-37   # normal, tiny scale
    x = x.reshape(rows, n).astype(np.float32)
    if dtype == "bf16":
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _pair(x, dtype):
    """The same input for both packages, in ``dtype``."""
    if dtype == "bf16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


def _assert_scales(got, want):
    """BITWISE, except subnormal scales, which the reference flushes."""
    got, want = np.asarray(got), np.asarray(want)
    sub = got < SUBNORMAL
    assert np.array_equal(got[~sub].view(np.int32), want[~sub].view(np.int32))
    assert np.all(want[sub] == 0.0)


CASES = [(1, 64 * 40, 64), (3, 64 * 40, 64), (1, 1024 * 12, 1024),
         (3, 1024 * 12, 1024)]
IDS = ["b64-1row", "b64-3rows", "b1024-1row", "b1024-3rows"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows,n,block", CASES, ids=IDS)
def test_quantize_matches_reference(rows, n, block, dtype):
    x = _x(rows, n, block, seed=n + rows, dtype=dtype)
    jx, tx = _pair(x, dtype)
    jc, js = jax_ops.quantize(jx, block)
    tc, ts = ops.quantize(tx, block)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (rows, n // block)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    _assert_scales(ts.numpy(), js)
    # the oracle module is the plain version
    oc, os_ = blockwise.quantize_blockwise(tx, block)
    assert torch.equal(oc, tc) and torch.equal(os_, ts)
    assert np.array_equal(
        oc.numpy(), np.asarray(jax_blockwise.quantize_blockwise(jx, block)[0]))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,n,block", CASES, ids=IDS)
def test_dequantize_into_matches_reference(rows, n, block, out_dtype):
    x = _x(rows, n, block, seed=2 * n + rows)
    jc, js = jax_ops.quantize(jnp.asarray(x), block)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    want = jax_ops.dequantize_into(jc, js, block, out_dtype=jdt)
    codes, scales = torch.from_numpy(np.asarray(jc)), \
        torch.from_numpy(np.asarray(js))
    got = ops.dequantize_into(codes, scales, block, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
    if out_dtype == torch.float32:
        assert torch.equal(ops.dequantize(codes, scales, block), got)
        assert torch.equal(blockwise.dequantize_blockwise(codes, scales,
                                                          block), got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows,n,block", CASES, ids=IDS)
def test_encode_ef_matches_reference(rows, n, block, dtype):
    ct = _x(rows, n, block, seed=3 * n + rows, dtype=dtype)
    ef = (np.random.default_rng(n).standard_normal((rows, n)) * 1e-2) \
        .astype(np.float32)
    jct, tct = _pair(ct, dtype)
    jc, js, jef = (np.asarray(a) for a in jax_ops.encode_ef(
        jct, jnp.asarray(ef), block))
    tc, ts, tef = ops.encode_ef(tct, torch.from_numpy(ef), block)
    assert np.array_equal(tc.numpy(), jc)
    _assert_scales(ts.numpy(), js)
    # the reference's residual is one FMA: comp - codes*scale rounded once
    comp = ct.astype(np.float32) + ef
    deq64 = jc.astype(np.float64).reshape(rows, -1, block) * \
        js.astype(np.float64)[..., None]
    fma = (comp.astype(np.float64) - deq64.reshape(rows, n)).astype(np.float32)
    assert np.array_equal(fma.view(np.int32), jef.view(np.int32))
    # the port rounds the product first
    deq = np.abs(deq64.reshape(rows, n)).astype(np.float32)
    bound = np.spacing(deq).astype(np.float64) / 2 + \
        np.spacing(np.abs(jef)).astype(np.float64)
    assert np.all(np.abs(tef.numpy().astype(np.float64) - jef) <= bound)


def test_encode_ef_in_place_on_cpu():
    ct = _x(2, 64 * 8, 64, seed=11)
    ef = np.full(ct.shape, 1e-3, np.float32)
    want = ops.encode_ef(torch.from_numpy(ct), torch.from_numpy(ef), 64)
    t_ef = torch.from_numpy(ef.copy())
    codes, scales = torch.empty_like(want[0]), torch.empty_like(want[1])
    out = ops.encode_ef(torch.from_numpy(ct), t_ef, 64,
                        out=(codes, scales, t_ef))
    assert out[2] is t_ef
    for a, b in zip((codes, scales, t_ef), want):
        assert torch.equal(a, b)


def _adam_inputs(rows, n, first_step, seed):
    r = np.random.default_rng(seed)
    w = (r.standard_normal((rows, n)) * 0.05).astype(np.float32)
    g = (r.standard_normal((rows, n)) * 1e-3).astype(np.float32)
    if first_step:
        m = np.zeros_like(w)
        v = np.zeros_like(w)
    else:
        m = (r.standard_normal((rows, n)) * 1e-4).astype(np.float32)
        v = np.abs(r.standard_normal((rows, n)) * 1e-7).astype(np.float32)
    mask = (r.random((rows, n)) < 0.8).astype(np.float32)
    t = np.float32(1 if first_step else 3)
    kw = dict(lr=np.float32(3e-4), b1=B1, b2=B2, eps=EPS, wd=WD,
              c1=np.float32(1) - np.float32(B1) ** t,
              c2=np.float32(1) - np.float32(B2) ** t)
    return (w, g, m, v, mask), kw


@pytest.mark.parametrize("first_step", [True, False],
                         ids=["zero_moments", "moments"])
@pytest.mark.parametrize("rows,n,block", CASES, ids=IDS)
def test_adamw_q8_epilogue_matches_reference(rows, n, block, first_step):
    """m', v' and the master in the flat epilogue's class (see
    tests/test_torch_kernels.py): m' and v' bitwise from zero moments;
    otherwise m' within one ulp of (1-b1)*g plus one ulp of m' and v'
    within one ulp; the master within lr times that m' difference carried
    through the update plus 4 ulp of max(|w|, |w - w'|).  The codes and
    scales follow the master: each side's are exactly the quantize of its
    own master, so a scale differs only by its block absmax's difference
    over 127 (plus an ulp), and a code by at most 1."""
    arrs, kw = _adam_inputs(rows, n, first_step, seed=n + rows)
    jcore, jm, jv = jax_ops.adamw_store_update(
        *map(jnp.asarray, arrs), fmt="q8_block", block=block, **kw)
    tcore, tm, tv = ops.adamw_store_update(
        *map(torch.from_numpy, arrs), fmt="q8_block", block=block, **kw)
    assert list(tcore) == list(jcore) == ["codes", "master", "scales"]
    f64 = np.float64
    jm, jv, tm, tv = (np.asarray(a, f64) for a in (jm, jv, tm, tv))
    w, g = arrs[0], arrs[1]
    if first_step:
        assert np.array_equal(tm, jm) and np.array_equal(tv, jv)
        dupd = 0.0
    else:
        term = np.spacing(np.abs((np.float32(1) - np.float32(B1)) * g))
        assert np.all(np.abs(tm - jm) <= term + np.spacing(
            np.abs(tm).astype(np.float32)))
        assert np.all(np.abs(tv - jv) <= np.spacing(
            np.abs(tv).astype(np.float32)))
        dupd = np.abs(tm - jm) / f64(kw["c1"]) / (
            np.sqrt(tv / f64(kw["c2"])) + EPS)
    tw, jw = tcore["master"].numpy(), np.asarray(jcore["master"])
    step = np.abs(f64(w) - tw)
    bound = f64(kw["lr"]) * dupd + 4 * np.spacing(
        np.maximum(np.abs(w), step).astype(np.float32))
    dw = np.abs(f64(tw) - jw)
    assert np.all(dw <= bound)
    dcodes = np.abs(tcore["codes"].numpy().astype(int) -
                    np.asarray(jcore["codes"]).astype(int))
    assert dcodes.max() <= 1
    ts, js = tcore["scales"].numpy(), np.asarray(jcore["scales"])
    dmax = dw.reshape(rows, -1, block).max(-1)
    assert np.all(np.abs(f64(ts) - js) <= dmax / 127 + np.spacing(ts))
    for core, quant in ((tcore, ops.quantize), (jcore, jax_ops.quantize)):
        codes, scales = quant(core["master"], block)
        assert np.array_equal(np.asarray(codes), np.asarray(core["codes"]))
        assert np.array_equal(np.asarray(scales), np.asarray(core["scales"]))
    flat, _, _ = ops.adamw_store_update(*map(torch.from_numpy, arrs), **kw)
    assert torch.equal(tcore["master"], flat)


def test_adamw_q8_in_place_on_cpu():
    arrs, kw = _adam_inputs(2, 64 * 8, False, seed=5)
    w, g, m, v, mask = (torch.from_numpy(a.copy()) for a in arrs)
    want, wm, wv = ops.adamw_store_update(w.clone(), g, m.clone(), v.clone(),
                                          mask, fmt="q8_block", block=64,
                                          **kw)
    codes = torch.empty_like(want["codes"])
    scales = torch.empty_like(want["scales"])
    core, m2, v2 = ops.adamw_store_update(
        w, g, m, v, mask, fmt="q8_block", block=64,
        out=(codes, w, scales, m, v), **kw)
    assert core["master"] is w and core["codes"] is codes and m2 is m
    for a, b in zip((codes, w, scales, m, v),
                    (want["codes"], want["master"], want["scales"], wm, wv)):
        assert torch.equal(a, b)


def _raises_like(ref_call, port_call):
    with pytest.raises(ValueError) as want:
        ref_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", [
    "quantize_ragged", "quantize_block0", "dequantize_ragged",
    "dequantize_scales", "encode_ef_shape", "encode_ef_ragged",
    "adamw_q8_block", "oracle_quantize", "oracle_scales"])
def test_value_errors_match_reference(case):
    x = np.ones((2, 96), np.float32)
    c = np.ones((2, 128), np.int8)
    s = np.ones((2, 3), np.float32)
    j, t = jnp.asarray, torch.from_numpy
    arrs, kw = _adam_inputs(1, 96, True, seed=0)
    calls = {
        "quantize_ragged": (lambda: jax_ops.quantize(j(x), 64),
                            lambda: ops.quantize(t(x), 64)),
        "quantize_block0": (lambda: jax_ops.quantize(j(x), 0),
                            lambda: ops.quantize(t(x), 0)),
        "dequantize_ragged": (
            lambda: jax_ops.dequantize_into(j(c), j(s), 96,
                                            out_dtype=jnp.float32),
            lambda: ops.dequantize_into(t(c), t(s), 96,
                                        out_dtype=torch.float32)),
        "dequantize_scales": (lambda: jax_ops.dequantize(j(c), j(s), 64),
                              lambda: ops.dequantize(t(c), t(s), 64)),
        "encode_ef_shape": (
            lambda: jax_ops.encode_ef(j(x), j(x[:1]), 32),
            lambda: ops.encode_ef(t(x), t(x[:1].copy()), 32)),
        "encode_ef_ragged": (lambda: jax_ops.encode_ef(j(x), j(x), 64),
                             lambda: ops.encode_ef(t(x), t(x), 64)),
        "adamw_q8_block": (
            lambda: jax_ops.adamw_store_update(*map(j, arrs), fmt="q8_block",
                                               block=64, **kw),
            lambda: ops.adamw_store_update(*map(t, arrs), fmt="q8_block",
                                           block=64, **kw)),
        "oracle_quantize": (
            lambda: jax_blockwise.quantize_blockwise(j(x), 64),
            lambda: blockwise.quantize_blockwise(t(x), 64)),
        "oracle_scales": (
            lambda: jax_blockwise.dequantize_blockwise(j(c), j(s), 64),
            lambda: blockwise.dequantize_blockwise(t(c), t(s), 64)),
    }
    _raises_like(*calls[case])


# --------------------------------------------------------------------------- #
# store, codec and schedule structure against the reference's objects
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fmt,ef_m", [("fp32", 0), ("fp32", 2),
                                      ("q8_block", 0), ("q8_block", 1),
                                      ("q8_block", 8)])
def test_store_structure_matches_reference(fmt, ef_m):
    want = jax_store.ParamStore(fmt, 64, ef_m)
    got = store.ParamStore(fmt, 64, ef_m)
    assert got.quantized == want.quantized and got.has_ef == want.has_ef
    assert got.align() == want.align()
    assert got.state_keys() == want.state_keys()
    shape = (3, 64 * 10)
    for k in want.state_keys() or ():
        assert got.leaf_shape(k, shape) == want._leaf_shape(k, shape), k
        assert str(got.leaf_dtype(k)).split(".")[-1] == \
            str(want.leaf_dtype(k)), k
    for n in (0, 640, 64 * 1000):
        assert got.wire_bytes(n, torch.bfloat16) == \
            want.wire_bytes(n, jnp.bfloat16)
        assert got.wire_bytes(n, torch.float32) == \
            want.wire_bytes(n, jnp.float32)


@pytest.mark.parametrize("fmt,ef_m", [("fp32", 0), ("q8_block", 0),
                                      ("fp32", 1), ("q8_block", 2)])
def test_store_create_and_views(fmt, ef_m):
    """``create`` on a master shard equals the reference's on the global
    buffer's columns; (trainable, frozen) round-trips through combine, and
    wrap_core/attach_ef rebuild the state's layout."""
    x = _x(2, 64 * 8, 64, seed=7)
    want = jax_store.ParamStore(fmt, 64, ef_m).create(x)
    s = store.ParamStore(fmt, 64, ef_m)
    got = s.create(torch.from_numpy(x.copy()))
    if s.state_keys() is None:
        assert torch.equal(got, torch.from_numpy(x))
        assert s.frozen(got) is None and s.combine(got, None) is got
        return
    assert list(got) == list(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.numpy().shape == w.shape, k
        if k == "scales":
            _assert_scales(v.numpy(), w)
        else:
            assert np.array_equal(v.numpy(), w), k
    master, frozen = s.trainable(got), s.frozen(got)
    assert master is got["master"]
    back = s.combine(master, frozen)
    assert list(back) == list(got)
    assert all(back[k] is got[k] for k in got)
    core = ({k: got[k] for k in ("codes", "master", "scales")}
            if s.quantized else master)
    rebuilt = s.wrap_core(core)
    if s.has_ef:
        rebuilt = s.attach_ef(rebuilt, got[store.EF_KEY])
    assert list(rebuilt) == list(got)


def test_store_gather_payload_and_errors():
    from repro_torch.launch.mesh import init_local_group

    group = init_local_group("gloo")
    s = store.ParamStore("q8_block", 64)
    state = s.create(torch.from_numpy(_x(1, 64 * 4, 64, seed=3)[0]))
    pay = s.gather_payload(state, group)
    assert torch.equal(pay["codes"], state["codes"])
    assert torch.equal(pay["scales"], state["scales"])
    with pytest.raises(ValueError, match="quantized only"):
        store.ParamStore().gather_payload(state, group)
    with pytest.raises(ValueError, match="without an EF residual"):
        s.attach_ef(state, state["master"])
    # the bf16 store (ported): a bare bf16 leaf, no payload to gather raw
    s16 = store.ParamStore("bf16")
    assert s16.state_keys() is None and s16.storage_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="quantized only"):
        s16.gather_payload(s16.create(state["master"]), group)


@pytest.mark.parametrize("fmt,block", [("fp32", 1024), ("bf16", 1024),
                                       ("q8_block", 64), ("q8_block", 1024)])
def test_wire_codec_matches_reference(fmt, block):
    want = jax_wire.WireCodec(fmt, block)
    got = wire.WireCodec(fmt, block)
    assert got.quantized == want.quantized
    for n in (0, 1024, 1024 * 77):
        assert got.wire_bytes(n) == want.wire_bytes(n)
    if got.quantized:
        with pytest.raises(ValueError, match="no single wire dtype"):
            got.dtype
        x = _x(2, block * 4, block, seed=block)
        enc = got.encode(torch.from_numpy(x))
        jenc = want.encode(jnp.asarray(x))
        assert np.array_equal(enc["codes"].numpy(), np.asarray(jenc["codes"]))
        dec = got.decode(enc, torch.bfloat16)
        jdec = want.decode(jenc, jnp.bfloat16)
        assert np.array_equal(dec.float().numpy(),
                              np.asarray(jdec.astype(jnp.float32)))


SCHEDULES = {
    "default": {},
    "fp32_reduce": dict(reduce_dtype="fp32"),
    "reduce_wire_bf16": dict(reduce_wire="bf16"),
    "reduce_wire_fp32": dict(reduce_wire="fp32"),
    "q8_store": dict(param_store="q8_block"),
    "q8_reduce": dict(reduce_wire="q8_block"),
    "q8_both_wires": dict(param_store="q8_block", reduce_wire="q8_block"),
    "q8_fp32_gather": dict(reduce_wire="q8_block", gather_dtype="fp32"),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_schedule_codecs_match_reference(name, compute):
    want = jax_schedule.CommSchedule(**SCHEDULES[name])
    got = schedule.CommSchedule(**SCHEDULES[name])
    jdt, tdt = ((jnp.float32, torch.float32) if compute == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    assert str(got.accum_dtype(tdt)).split(".")[-1] == \
        str(want.accum_dtype(jdt))
    assert got.ef_enabled == want.ef_enabled
    for block in (64, 1024):
        rc, jrc = got.reduce_codec(tdt, block), want.reduce_codec(jdt, block)
        assert (rc.fmt, rc.block) == (jrc.fmt, jrc.block)
    assert got.gather_codec(tdt).fmt == want.gather_codec(jdt).fmt
    got.validate_for(tdt)
    want.validate_for(jdt)


def test_schedule_q8_errors_match_reference():
    for kw in (dict(reduce_wire="q8_block", reduce_dtype="fp32"),
               dict(reduce_wire="int4")):
        _raises_like(lambda: jax_schedule.CommSchedule(**kw),
                     lambda: schedule.CommSchedule(**kw))
    kw = dict(param_store="q8_block", gather_dtype="bf16")
    _raises_like(
        lambda: jax_schedule.CommSchedule(**kw).validate_for(jnp.bfloat16),
        lambda: schedule.CommSchedule(**kw).validate_for(torch.bfloat16))
    # the fp8 reduce wire (ported): the reference's cast codec
    fp8 = dict(reduce_wire="fp8_e4m3")
    assert schedule.CommSchedule(**fp8).reduce_codec(torch.bfloat16).fmt == \
        jax_schedule.CommSchedule(**fp8).reduce_codec(jnp.bfloat16).fmt == \
        "fp8_e4m3"
    # the q8 ring_acc route (ported): the reference's schedule
    kw = dict(reduce_wire="q8_block", reduce_mode="ring_acc")
    assert schedule.CommSchedule(**kw).describe() == \
        jax_schedule.CommSchedule(**kw).describe()


def test_group_override_displaces_the_other_reduce_spelling():
    base = schedule.CommSchedule(reduce_dtype="fp32")
    got = schedule.resolve_group_schedules(
        base, {"layers": {"reduce_wire": "q8_block"}})["layers"]
    want = jax_schedule.resolve_group_schedules(
        jax_schedule.CommSchedule(reduce_dtype="fp32"),
        {"layers": {"reduce_wire": "q8_block"}})["layers"]
    assert (got.reduce_wire, got.reduce_dtype) == \
        (want.reduce_wire, want.reduce_dtype) == ("q8_block", None)


# --------------------------------------------------------------------------- #
# the q8 reduce-scatter on one rank and on two gloo ranks
# --------------------------------------------------------------------------- #
def _ref_route(cts, efs, block):
    """The reference's kernels composed in rank order: each rank encodes
    ct + ef once; destination j sums the dequantized chunks j of ranks 0..
    n-1 in that order."""
    n = len(cts)
    enc = [jax_ops.encode_ef(jnp.asarray(c), jnp.asarray(e), block)
           for c, e in zip(cts, efs)]
    c = cts[0].shape[-1] // n
    shards = []
    for j in range(n):
        total = None
        for codes, scales, _ in enc:
            part = jax_ops.dequantize(codes[j * c:(j + 1) * c],
                                      scales[j * c // block:
                                             (j + 1) * c // block], block)
            total = part if total is None else total + part
        shards.append(np.asarray(total))
    return shards, [np.asarray(e[2]) for e in enc]


def test_q8_reduce_scatter_one_rank_matches_reference():
    from repro_torch.launch.mesh import init_local_group

    group = init_local_group("gloo")
    cts, efs = QW.inputs(1, 64 * 24)
    want, want_ef = _ref_route(cts, efs, 64)
    ef = torch.from_numpy(efs[0].copy())
    got = wire.codec_reduce_scatter(torch.from_numpy(cts[0]), ef,
                                    wire.WireCodec("q8_block", 64), group,
                                    torch.float32)
    assert np.array_equal(got.numpy().view(np.int32), want[0].view(np.int32))
    _, _, plain_ef = ref.encode_ef_ref(torch.from_numpy(cts[0]),
                                       torch.from_numpy(efs[0]), 64)
    assert torch.equal(ef, plain_ef)  # the residual, updated in place
    # without a residual the codec's plain encode runs
    got = wire.codec_reduce_scatter(torch.from_numpy(cts[0]), None,
                                    wire.WireCodec("q8_block", 64), group,
                                    torch.float32)
    jc, js = jax_ops.quantize(jnp.asarray(cts[0]), 64)
    assert np.array_equal(got.numpy(),
                          np.asarray(jax_ops.dequantize(jc, js, 64)))
    with pytest.raises(ValueError, match="only defined for quantized"):
        wire.codec_reduce_scatter(torch.from_numpy(cts[0]), ef,
                                  wire.WireCodec("fp32"), group,
                                  torch.float32)


def test_q8_reduce_scatter_two_ranks_bitwise(tmp_path):
    """Two gloo ranks run the port's match-mode route; each rank's shard
    equals the reference's kernels composed in rank order bitwise, and
    each rank's new residual equals the plain encode_ef's bitwise."""
    world, n = 2, 64 * 24
    ctx = multiprocessing.get_context("spawn")
    init_file = str(tmp_path / "store")
    prefix = str(tmp_path / "rank")
    procs = [ctx.Process(target=QW.rank_main,
                         args=(r, world, init_file, prefix, n))
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
    cts, efs = QW.inputs(world, n)
    want, _ = _ref_route(cts, efs, 64)
    for r in range(world):
        out = np.load(f"{prefix}{r}.npz")
        assert out["shard"].shape == (n // world,)
        assert np.array_equal(out["shard"].view(np.int32),
                              want[r].view(np.int32)), r
        _, _, plain_ef = ref.encode_ef_ref(torch.from_numpy(cts[r]),
                                           torch.from_numpy(efs[r]), 64)
        assert np.array_equal(out["ef"], plain_ef.numpy()), r


def test_store_and_schedule_validation():
    """The reference's validation (tests/test_store.py), on the port."""
    with pytest.raises(ValueError):
        schedule.CommSchedule(param_store="int4")
    with pytest.raises(ValueError):
        store.ParamStore("int4")
    with pytest.raises(ValueError):
        store.ParamStore("q8_block", 0)
    with pytest.raises(ValueError):
        store.ParamStore("q8_block", 64, -1)
    with pytest.raises(ValueError):
        schedule.CommSchedule(param_store="q8_block",
                              gather_dtype="fp32").validate_for(torch.bfloat16)
    schedule.CommSchedule(param_store="q8_block").validate_for(torch.bfloat16)
    with pytest.raises(ValueError):
        schedule.CommSchedule(reduce_mode="tree")
    with pytest.raises(ValueError, match="planner align missing"):
        store.ParamStore("q8_block", 64).leaf_shape("scales", (2, 100))


@pytest.mark.parametrize("block", [64, 1024])
def test_q8_codec_error_bound(block):
    """decode(encode(x)) is within half a quant step of x, block by block
    (the reference's tests/test_wire.py bound), away from the 1e-30
    floor under the scale."""
    r = np.random.default_rng(block)
    x = (r.standard_normal((2, block * 16)) *
         np.repeat(np.exp(r.uniform(-7, 2, (2, 16))), block, axis=1)) \
        .astype(np.float32)
    codec = wire.WireCodec("q8_block", block)
    pay = codec.encode(torch.from_numpy(x))
    back = codec.decode(pay, torch.float32).numpy().reshape(2, -1, block)
    step = pay["scales"].numpy()[..., None].astype(np.float64)
    err = np.abs(back - x.reshape(2, -1, block))
    assert np.all(err <= step / 2 + np.spacing(np.abs(x.reshape(
        2, -1, block))))
    assert codec.wire_bytes(x.size) == x.size + 4 * x.size // block
