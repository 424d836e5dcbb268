"""The port's non-element-wise optimizers against the JAX reference on the
CPU: ``newton_schulz`` and ``_inv_4th_root`` on square, wide and tall
matrices; one SGD, Muon and Shampoo update on ``qwen2.5-14b.reduced()``
from identical numpy parameters, gradients and state (the reference's
``update`` run under ``shard_map`` on one device); the state layouts
(factor keys and shapes included, at 1 and 4 ranks); the mask row.

Parity classes, measured (bounds asserted about four times the largest
reading, stated per test):
  * Newton-Schulz: ALLCLOSE -- fp32 ``torch.matmul`` sums in another order
    than XLA's dot, amplified by five quintic steps.
  * ``_inv_4th_root``: ALLCLOSE -- LAPACK's ``syevd`` against XLA's
    eigensolver; ``V w^-1/4 V^T`` is basis-free, so the two agree to the
    solvers' accuracy.
  * one update: ALLCLOSE on the step ``w' - w`` and on every state leaf
    (SGD's chain rounds as XLA's except where XLA contracts an FMA).
  * state layouts and the mask row: EXACT.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.core.policy import plan as jax_plan
from repro.core.schedule import CommSchedule as JaxSchedule
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim.common import matrix_mask_local as jax_mask
from repro.optim.muon import newton_schulz as jax_ns
from repro.optim.shampoo import _inv_4th_root as jax_inv4

from repro_torch.configs import build_model, get_config
from repro_torch.core.fsdp import FSDPRuntime, load_reference_state
from repro_torch.core.policy import plan
from repro_torch.core.schedule import CommSchedule
from repro_torch.launch.mesh import init_local_group
from repro_torch.optim import OPTIMIZERS, make_optimizer
from repro_torch.optim.common import (device_linear_index, mask_rows,
                                      matrix_mask_local, pieces)
from repro_torch.optim.muon import muon_scale, newton_schulz
from repro_torch.optim.shampoo import _inv_4th_root

torch.set_num_threads(2)

ARCH = "qwen2.5-14b"
SHAPES = [(64, 64), (32, 96), (96, 24), (256, 512), (512, 128)]
NS_BOUND = 2e-5        # measured up to 4.6e-6 (relative L2)
INV4_BOUND = 1e-5      # measured up to 1.6e-6 (well conditioned)
# per optimizer: the step w' - w and the state leaves (relative L2)
UPDATE_BOUND = {"sgd": 1e-4, "muon": 4e-5, "shampoo": 1e-5}
STORES = {"fp32": {}, "q8_block": {"param_store": "q8_block"}}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_newton_schulz_matches_reference(shape):
    """Single matrices and a batch of three (the reference's ``vmap``) of
    N(0, 1) entries: relative L2 within ``NS_BOUND``; the tall shapes take
    the transpose on both sides."""
    G = np.random.default_rng(sum(shape)).standard_normal(
        (3,) + shape).astype(np.float32)
    want = np.stack([np.asarray(jax_ns(jnp.asarray(g))) for g in G])
    got = newton_schulz(torch.from_numpy(G)).numpy()
    assert got.shape == G.shape and got.dtype == np.float32
    assert _rel(got, want) < NS_BOUND
    one = newton_schulz(torch.from_numpy(G[0])).numpy()
    assert _rel(one, want[0]) < NS_BOUND


def test_muon_scale_is_float32():
    for a, b in ((96, 24), (13824, 5120), (5120, 1024), (24, 96), (64, 64)):
        want = float(jnp.sqrt(jnp.maximum(1.0, a / b)))
        assert muon_scale(a, b) == want


@pytest.mark.parametrize("k,rank", [(64, 128), (256, 512), (96, 32),
                                    (128, 0), (64, 64), (256, 256)],
                         ids=str)
def test_inv_4th_root_matches_reference(k, rank):
    """``G G^T`` of a (k, rank) gradient, as a Shampoo factor accumulates:
    wide (well conditioned), rank-deficient (the clamp decides the null
    space), the zero factor of a padded layer, and square (condition
    number 2e5-2e6, where an fp32 eigensolver is accurate to ~1e-3 on the
    smallest eigenvalues).  Against a float64 eigendecomposition of the
    same fp32 matrix, the port is as accurate as the reference: its
    relative L2 at most twice the reference's plus 1e-6 (measured 0.5-1.2x
    on the square cases); port vs reference within ``INV4_BOUND`` where
    the matrix is well conditioned or clamped (measured up to 1.6e-6), and
    within 4e-3 on the square ones (measured 7.6e-4)."""
    r = np.random.default_rng(k + rank)
    g = r.standard_normal((2, k, max(rank, 1))).astype(np.float32) * 0.1
    M = (g @ g.transpose(0, 2, 1)) if rank else np.zeros((2, k, k),
                                                         np.float32)
    want = np.stack([np.asarray(jax_inv4(jnp.asarray(m))) for m in M])
    got = _inv_4th_root(torch.from_numpy(M)).numpy()
    assert got.dtype == np.float32
    w, V = np.linalg.eigh(M.astype(np.float64))
    w = np.maximum(w, 1e-6 * np.maximum(w.max(-1, keepdims=True), 1.0))
    truth = (V * w[:, None, :] ** -0.25) @ V.transpose(0, 2, 1)
    assert _rel(got, truth) <= 2 * _rel(want, truth) + 1e-6
    assert _rel(got, want) < (4e-3 if k == rank else INV4_BOUND)


# ---------------------------------------------------------------------------
# one update from the same numpy state
# ---------------------------------------------------------------------------

def _cfgs(opt, **kw):
    j = dataclasses.replace(jax_get_config(ARCH).reduced(), optimizer=opt,
                            learning_rate=1e-2, **kw)
    t = dataclasses.replace(get_config(ARCH).reduced(), optimizer=opt,
                            learning_rate=1e-2, **kw)
    return j, t


def _state(rt_shapes, seed):
    """Numpy optimizer state at ``rt_shapes`` ({key: {leaf: shape}}):
    moments N(0, 1e-3), second moments |N(0, 1e-6)|, factors G G^T / k."""
    r = np.random.default_rng(seed)
    out = {}
    for k, leaves in rt_shapes.items():
        out[k] = {}
        for name, shape in leaves.items():
            if k == "factors":
                g = r.standard_normal(shape).astype(np.float32) * 1e-2
                a = (g @ g.transpose(0, 2, 1)) / shape[-1]
            elif k == "v":
                a = np.abs(r.standard_normal(shape)) * 1e-6
            else:
                a = r.standard_normal(shape) * 1e-3
            out[k][name] = a.astype(np.float32)
    return out


def _jax_update(jcfg, store, params, grads, state, step):
    rt = JaxRuntime(jax_build_model(jcfg), make_local_mesh(1, 1),
                    compute_dtype=jnp.float32,
                    schedule=JaxSchedule(**STORES[store]))
    opt = jax_make_optimizer(jcfg)
    pspecs = rt._param_specs()
    gspecs = {n: lo.pspec() for n, lo in rt.layouts.items()}
    ospecs = opt.pspecs(rt)

    def fn(p, g, s, st):
        return opt.update(rt, p, g, s, st)

    f = shard_map(fn, mesh=rt.mesh, in_specs=(pspecs, gspecs, ospecs, P()),
                  out_specs=(pspecs, ospecs))
    to_j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    new_p, new_s = jax.jit(f)(to_j(params), to_j(grads), to_j(state),
                              jnp.int32(step))
    return jax.tree.map(np.asarray, new_p), jax.tree.map(np.asarray, new_s)


def _master(state):
    return state["master"] if isinstance(state, dict) else state


@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("opt", ["sgd", "muon", "shampoo"])
def test_single_update_matches_reference(opt, store):
    """One ``update`` at step 3 from the reference's init (both packages'
    ``init_params(0)`` are bitwise the same), N(0, 1e-3) gradients and a
    random state: the step ``w' - w`` of every group and every state leaf
    (Shampoo's factors included) within ``UPDATE_BOUND`` relative L2 of the
    reference's.  Measured on the step: SGD 2.8e-5, Muon 8.1e-6, Shampoo
    1.6e-6 -- XLA contracts ``b * m + c * g`` and ``w - lr * u`` into FMAs
    where the port rounds both products, so m', v' and mom' differ by an
    ulp on 23-29% of the elements (state within 4.3e-8) and w' by an ulp on
    0.004-3%, which on a step of 1e-5 against a weight of 1e-1 reads as
    1e-5 relative; Shampoo's ``mom`` 1.9e-6, its factors bitwise but for
    the two (a, b) = (256, 512) left factors (3.1e-7).  On the q8_block
    store the codes are the requantized master's on both sides: measured
    bitwise, asserted within one step (a code moves by one where the two
    masters straddle a rounding boundary)."""
    jcfg, tcfg = _cfgs(opt)
    rt = FSDPRuntime(build_model(tcfg), init_local_group("gloo"),
                     compute_dtype=torch.float32, device="cpu",
                     schedule=CommSchedule(**STORES[store]))
    topt = make_optimizer(tcfg)
    topt.init(rt)
    shapes = {k: {n: s for n, (_, s, _) in leaves.items()}
              for k, leaves in topt.state_layout(rt).items()}
    state_np = _state(shapes, seed=1)
    r = np.random.default_rng(2)
    grads_np = {n: (r.standard_normal(lo.global_shape()) * 1e-3)
                .astype(np.float32) for n, lo in rt.layouts.items()}
    params = rt.init_params(0)
    params_np = {n: ({k: v.detach().numpy().copy() for k, v in p.items()}
                     if isinstance(p, dict) else p.detach().numpy().copy())
                 for n, p in params.items()}
    want_p, want_s = _jax_update(jcfg, store, params_np, grads_np, state_np,
                                 step=3)

    params, state = load_reference_state(rt, params_np, state_np)
    grads = {n: torch.from_numpy(g) for n, g in grads_np.items()}
    got_p, got_s = topt.update(rt, params, grads, state, 3)
    bound = UPDATE_BOUND[opt]
    for name in rt.layouts:
        w0 = _master(params_np[name])
        step_got = _master(got_p[name]).detach().numpy() - w0
        step_want = _master(want_p[name]) - w0
        assert _rel(step_got, step_want) < bound, (name, "step")
        if store == "q8_block":
            codes = got_p[name]["codes"].numpy().astype(np.int32)
            assert np.abs(codes - want_p[name]["codes"]).max() <= 1, name
            assert _rel(got_p[name]["scales"], want_p[name]["scales"]) \
                < bound, name
    assert sorted(got_s) == sorted(want_s)
    for k, leaves in want_s.items():
        assert sorted(got_s[k]) == sorted(leaves), k
        for name, want in leaves.items():
            got = got_s[k][name].numpy()
            assert got.shape == want.shape and got.dtype == want.dtype
            assert _rel(got, want) < bound, (k, name)


def test_updates_write_in_place():
    """The state's leaves, the master and (q8) its codes and scales are
    the same tensors after the update: the gather buffers and the master's
    ``.grad`` stay where the train step put them."""
    for opt in ("sgd", "muon", "shampoo"):
        _, tcfg = _cfgs(opt)
        rt = FSDPRuntime(build_model(tcfg), init_local_group("gloo"),
                         compute_dtype=torch.float32, device="cpu",
                         schedule=CommSchedule(param_store="q8_block"))
        o = make_optimizer(tcfg)
        state = o.init(rt)
        params = rt.init_params(0)
        before = {n: dict(p) for n, p in params.items()}
        leaves = {(k, n): t for k, g in state.items() for n, t in g.items()}
        grads = {n: torch.full(lo.local_shape(), 1e-3)
                 for n, lo in rt.layouts.items()}
        new_p, new_s = o.update(rt, params, grads, state, 0)
        for n, p in new_p.items():
            assert all(p[k] is before[n][k] for k in p), (opt, n)
        for (k, n), t in leaves.items():
            assert new_s[k][n] is t, (opt, k, n)


def test_pieces_cover_each_element_once():
    t = torch.zeros(3, 10)
    for (lo, hi), (v, none) in pieces(t, None, chunk=4):
        assert none is None and v.shape == (hi - lo,)
        v.add_(1)
    assert torch.equal(t, torch.ones(3, 10))


# ---------------------------------------------------------------------------
# state layouts and the mask row
# ---------------------------------------------------------------------------

def _fake_runtimes(m):
    """Both packages' plans of qwen2.5-14b.reduced() at 3 layers on m ranks,
    as the runtime attributes the state layouts read (no process group or
    mesh of m devices is needed)."""
    jcfg, tcfg = _cfgs("shampoo", n_layers=3)
    mesh = {"data": m, "model": 1}
    jp = jax_plan(jax_build_model(jcfg), mesh)
    tp = plan(build_model(tcfg), mesh)
    jrt = types.SimpleNamespace(
        layouts=jp.groups, mesh=types.SimpleNamespace(
            axis_names=("data", "model"),
            devices=types.SimpleNamespace(shape=(m, 1))))
    return jrt, tp.groups


@pytest.mark.parametrize("m", [1, 4])
def test_factor_layout_matches_reference(m):
    """Shampoo's factor keys and global shapes ``(Lp, k, k)`` (L = 3
    padded to 4 on four ranks) equal the reference's ``_factor_specs``,
    each sharded over its leading axis."""
    jrt, groups = _fake_runtimes(m)
    want = {k: shape for k, (shape, _) in
            jax_make_optimizer(_cfgs("shampoo")[0])._factor_specs(
                jrt).items()}
    trt = types.SimpleNamespace(layouts=groups)
    got = make_optimizer(_cfgs("shampoo")[1]).extra_leaves(trt)["factors"]
    assert list(got) == list(want)
    for k, (dtype, shape, axis) in got.items():
        assert shape == want[k] and dtype == torch.float32 and axis == 0
        assert shape[0] == (4 if m == 4 else 3)


@pytest.mark.parametrize("opt", ["sgd", "muon", "shampoo"])
def test_state_shapes_match_reference(opt):
    """The global shapes of ``state_layout`` equal the reference's
    ``state_shapes`` leaf for leaf (keys, shapes, fp32); on one rank the
    local shapes (``state_shapes``) are the global ones."""
    jcfg, tcfg = _cfgs(opt)
    jrt = JaxRuntime(jax_build_model(jcfg), make_local_mesh(1, 1))
    want = jax_make_optimizer(jcfg).state_shapes(jrt)
    rt = FSDPRuntime(build_model(tcfg), init_local_group("gloo"),
                     device="cpu")
    o = make_optimizer(tcfg)
    got = {k: {n: (dtype, shape) for n, (dtype, shape, _) in leaves.items()}
           for k, leaves in o.state_layout(rt).items()}
    assert sorted(got) == sorted(want)
    for k, leaves in want.items():
        assert sorted(got[k]) == sorted(leaves), k
        for name, sds in leaves.items():
            assert got[k][name] == (torch.float32, tuple(sds.shape)), (k, name)
    assert o.state_shapes(rt) == got
    state = o.init(rt)
    assert {k: {n: (t.dtype, tuple(t.shape)) for n, t in g.items()}
            for k, g in state.items()} == got


def test_mask_row_matches_reference():
    """Each group's mask is one ``(S,)`` uint8 row (never ``(L, S)``), and
    its values are the reference's traced ``matrix_mask_local`` of every
    layer row; ``device_linear_index`` is the rank."""
    jcfg, tcfg = _cfgs("muon")
    jrt = JaxRuntime(jax_build_model(jcfg), make_local_mesh(1, 1))
    rt = FSDPRuntime(build_model(tcfg), init_local_group("gloo"),
                     device="cpu")
    rows = mask_rows(rt)
    o = make_optimizer(tcfg)
    o.init(rt)
    for name, lo in rt.layouts.items():
        jlo = jrt.layouts[name]
        shape = jlo.global_shape()
        want = np.asarray(shard_map(
            lambda: jax_mask(jrt, jlo, shape), mesh=jrt.mesh, in_specs=(),
            out_specs=jlo.pspec())())
        row = rows[name]
        assert row.dtype == torch.uint8 and tuple(row.shape) == (
            lo.plan.shard_size,)
        for r in (want if lo.n_layers else want[None]):
            assert np.array_equal(r, row.numpy().astype(np.float32))
        assert np.array_equal(row.numpy(), matrix_mask_local(lo, 0))
        assert device_linear_index(rt, lo) == 0
        assert torch.equal(o._masks[name], row)


def test_optimizers_are_registered():
    assert set(OPTIMIZERS) == {"adamw", "adam8bit", "sgd", "muon",
                               "shampoo"}
    for name in ("sgd", "muon", "shampoo"):
        assert type(make_optimizer(_cfgs(name)[1])).__name__ == \
            type(jax_make_optimizer(_cfgs(name)[0])).__name__
