"""The port's recurrent mixers (``repro_torch.models.ssm``) against the JAX
reference's (``repro.models.ssm``): ``diagonal_scan``, ``mamba_mix``,
``mlstm_mix`` and ``slstm_mix``, forward and gradients, with and without
an incoming state, at fp32 on inputs and weights drawn from a numpy seed;
and the reference's own invariants, ported (``tests/test_models.py``: the
chunked scans equal the step-by-step ones, a carried state composes).

Parity class: ALLCLOSE at fp32.  The scans associate in another order
than XLA's (``diagonal_scan``'s log-depth passes against
``lax.associative_scan``'s odd/even recursion) and the matmul sums run in
PyTorch's order.  Measured (relative L2): ``diagonal_scan`` up to 8.0e-8
against the reference and the float64 loop, its gradients 9.0e-8; the
mixers' outputs, states and gradients against the reference up to 8.2e-7
(the mLSTM's, through its ``exp`` of cumulative log gates; Mamba 3.2e-7,
sLSTM 2.1e-7); chunked against step by step up to 4.3e-7, a continued
call against one call up to 1.9e-7.  Asserted: 1e-5 on every output,
state and gradient.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import ssm as J

from repro_torch.models import ssm as P

torch.set_num_threads(2)

RTOL = 1e-5


class Cfg:
    n_heads = 4
    ssm_state = 8
    ssm_expand = 2
    conv_kernel = 4


D = 64
MIXERS = {
    "mamba_mix": (J.mamba_param_shapes(Cfg, D, d_inner=D), {"d_inner": D}),
    "mlstm_mix": (J.mlstm_param_shapes(Cfg, D), {}),
    "slstm_mix": (J.slstm_param_shapes(Cfg, D), {}),
}


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# diagonal_scan
# ---------------------------------------------------------------------------

def _sequential(a, b, h0):
    """h_t = a_t h_{t-1} + b_t in float64, one position at a time."""
    h = np.asarray(h0, np.float64)
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, 1), h


@pytest.mark.parametrize("T,chunk", [(37, 8), (300, 256), (5, 256),
                                     (64, 16)])
def test_diagonal_scan_matches_reference_and_sequential(T, chunk):
    """T not a multiple of the chunk (37 / 8, 300 / 256), shorter than one
    (5), and a whole number of chunks; a carried ``h0`` (the state of a
    continuation) and none."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (2, T, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, T, 3, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    for init in (h0, None):
        hj, lj = J.diagonal_scan(jnp.asarray(a), jnp.asarray(b),
                                 None if init is None else jnp.asarray(init),
                                 chunk=chunk)
        ht, lt = P.diagonal_scan(_t(a), _t(b),
                                 None if init is None else _t(init),
                                 chunk=chunk)
        hs, hl = _sequential(a.astype(np.float64), b.astype(np.float64),
                             np.zeros_like(h0) if init is None else init)
        assert ht.shape == (2, T, 3, 4) and lt.shape == (2, 3, 4)
        assert _rel(ht, hj) < RTOL and _rel(lt, lj) < RTOL
        assert _rel(ht, hs) < RTOL and _rel(lt, hl) < RTOL


def test_diagonal_scan_carry_composes():
    """prefill(T) then decode(1) equals prefill(T + 1): the serve path's
    contract (the reference's ``test_diagonal_scan_carry_composes``)."""
    rng = np.random.default_rng(0)
    B, T, d = 1, 9, 4
    a = _t(rng.uniform(0.6, 1, (B, T + 1, d)))
    b = _t(rng.normal(size=(B, T + 1, d)))
    full, _ = P.diagonal_scan(a, b, chunk=4)
    _, h = P.diagonal_scan(a[:, :T], b[:, :T], chunk=4)
    step, _ = P.diagonal_scan(a[:, T:], b[:, T:], h0=h, chunk=4)
    assert _rel(step[:, 0], full[:, T]) < RTOL


def test_diagonal_scan_gradient_matches_reference():
    """The gradients of a weighted sum of ``h`` and ``h_last`` with respect
    to a, b and h0."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0.5, 1.0, (2, 40, 6)).astype(np.float32)
    b = rng.normal(size=(2, 40, 6)).astype(np.float32)
    h0 = rng.normal(size=(2, 6)).astype(np.float32)
    w = rng.normal(size=(2, 40, 6)).astype(np.float32)
    wl = rng.normal(size=(2, 6)).astype(np.float32)

    def jf(a, b, h0):
        h, hl = J.diagonal_scan(a, b, h0, chunk=16)
        return jnp.sum(h * w) + jnp.sum(hl * wl)

    want = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(h0))
    ins = [_t(x).requires_grad_(True) for x in (a, b, h0)]
    h, hl = P.diagonal_scan(*ins, chunk=16)
    (torch.sum(h * _t(w)) + torch.sum(hl * _t(wl))).backward()
    for t, g in zip(ins, want):
        assert _rel(t.grad, g) < RTOL


# ---------------------------------------------------------------------------
# the mixers: forward, state, gradients
# ---------------------------------------------------------------------------

def _inputs(name, T, seed):
    rng = np.random.default_rng(seed)
    shapes, _ = MIXERS[name]
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    x = rng.normal(size=(2, T, D)).astype(np.float32)
    return p, x


def _state_like(name, seed):
    """An incoming state of the mixer's form: the reference's state after
    a prefill of 9 tokens of another input."""
    p, x = _inputs(name, 9, seed + 100)
    _, kw = MIXERS[name]
    _, st = getattr(J, name)(Cfg, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), **kw)
    return {k: np.asarray(v, np.float32) for k, v in st.items()}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_forward_and_gradients_match_reference(name, with_state):
    """One call of 41 tokens (the mLSTM: a whole chunk of 41; an sLSTM
    loop of 41 steps), from nothing or from an incoming state: the output
    and the new state, then the gradients of a weighted sum of both with
    respect to x, every parameter and the incoming state."""
    T = 41
    p, x = _inputs(name, T, 0)
    _, kw = MIXERS[name]
    st = _state_like(name, 0) if with_state else None
    rng = np.random.default_rng(7)
    w_out = rng.normal(size=(2, T, D)).astype(np.float32)
    fn_j, fn_t = getattr(J, name), getattr(P, name)
    _, st_shape = fn_j(Cfg, {k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), **kw)
    w_st = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in st_shape.items()}

    def jf(x, p, st):
        out, ns = fn_j(Cfg, p, x, state=st, **kw)
        return jnp.sum(out * w_out) + sum(jnp.sum(ns[k] * w_st[k])
                                          for k in w_st), (out, ns)

    jargs = (jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
             None if st is None else {k: jnp.asarray(v)
                                      for k, v in st.items()})
    (_, (out_j, ns_j)), grads_j = jax.value_and_grad(
        jf, argnums=(0, 1, 2) if st is not None else (0, 1),
        has_aux=True)(*jargs)

    xt = _t(x).requires_grad_(True)
    pt = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    stt = None if st is None else {k: _t(v).requires_grad_(True)
                                   for k, v in st.items()}
    out_t, ns_t = fn_t(Cfg, pt, xt, state=stt, **kw)
    assert _rel(out_t.detach(), out_j) < RTOL
    assert set(ns_t) == set(ns_j)
    for k in ns_j:
        assert ns_t[k].dtype == torch.float32
        assert _rel(ns_t[k].detach(), ns_j[k]) < RTOL, k
    loss = torch.sum(out_t * _t(w_out)) + sum(
        torch.sum(ns_t[k] * _t(w_st[k])) for k in w_st)
    loss.backward()
    assert _rel(xt.grad, grads_j[0]) < RTOL
    for k, g in grads_j[1].items():
        assert _rel(pt[k].grad, g) < RTOL, k
    if st is not None:
        for k, g in grads_j[2].items():
            assert _rel(stt[k].grad, g) < RTOL, k


@pytest.mark.parametrize("name", list(MIXERS))
def test_chunked_equals_step_by_step(name):
    """The whole sequence in one call equals one token a call carrying the
    state (ref ``tests/test_models.py``: ``test_mlstm_chunk_invariance``,
    ``test_slstm_sequential_state``; the Mamba mixer too), outputs and
    final state.  33 tokens: the mLSTM's one chunk against 33 of one."""
    T = 33
    p, x = _inputs(name, T, 3)
    _, kw = MIXERS[name]
    pt = {k: _t(v) for k, v in p.items()}
    xt = _t(x)
    fn = getattr(P, name)
    full, st_full = fn(Cfg, pt, xt, **kw)
    st, outs = None, []
    for t in range(T):
        o, st = fn(Cfg, pt, xt[:, t:t + 1], state=st, **kw)
        outs.append(o)
    assert _rel(torch.cat(outs, 1), full) < RTOL
    for k in st_full:
        assert _rel(st[k], st_full[k]) < RTOL, k


@pytest.mark.parametrize("name", list(MIXERS))
def test_carry_composes(name):
    """A prefill of 20 tokens, then 13 more from its state, equals one
    call of 33 (outputs of the second part, final state): the serve
    path's prefill-then-continue."""
    p, x = _inputs(name, 33, 4)
    _, kw = MIXERS[name]
    pt = {k: _t(v) for k, v in p.items()}
    xt = _t(x)
    fn = getattr(P, name)
    full, st_full = fn(Cfg, pt, xt, **kw)
    _, st = fn(Cfg, pt, xt[:, :20], **kw)
    rest, st2 = fn(Cfg, pt, xt[:, 20:], state=st, **kw)
    assert _rel(rest, full[:, 20:]) < RTOL
    for k in st_full:
        assert _rel(st2[k], st_full[k]) < RTOL, k


def test_slstm_stabiliser_starts_at_minus_1e30():
    """A state of zeros with ``m`` at -1e30 is the sLSTM's own start
    (the value ``init_cache`` gives the cache's ``s/m``)."""
    p, x = _inputs("slstm_mix", 7, 5)
    pt = {k: _t(v) for k, v in p.items()}
    start = {k: torch.zeros(2, Cfg.n_heads, D // Cfg.n_heads)
             for k in ("c", "n")}
    start["m"] = torch.full_like(start["c"], P.SLSTM_M0)
    a, sa = P.slstm_mix(Cfg, pt, _t(x))
    b, sb = P.slstm_mix(Cfg, pt, _t(x), state=start)
    assert torch.equal(a, b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
