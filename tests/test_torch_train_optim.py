"""Training with the non-element-wise optimizers against the JAX reference:
the quickstart loop on ``qwen2.5-14b.reduced()`` (2 layers, d_model 256,
qkv bias, batch 8 x 64, learning rate 1e-2, fp32 compute) for five steps
on one rank with SGD, Muon and Shampoo on the fp32 store and Muon on the
q8_block and bf16 stores; a reference Muon state and a Shampoo state
(factors included) carried across after two steps; and 2 and 4 gloo ranks
against one at 3 layers (4 ranks pad the layer axis to 4).

Parity class: ALLCLOSE, bounds stated per test.  The optimizers' chains
differ from XLA's by its FMA contractions (an ulp of m', v', mom' and w'
on part of the elements), Newton-Schulz and the eigensolver by their sum
orders; five steps carry that into the loss at 1e-7-1e-6.
"""
import dataclasses
import multiprocessing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.core.schedule import CommSchedule as JaxSchedule
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticStream as JaxStream
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer as jax_make_optimizer

import _torch_optim_worker as OW
import _torch_train_worker as W
from repro_torch.core.dbuffer import DBuffer
from repro_torch.core.fsdp import load_reference_state
from repro_torch.core.policy import plan
from repro_torch.core.schedule import CommSchedule
from repro_torch.launch.mesh import init_local_group

torch.set_num_threads(2)

ARCH = "qwen2.5-14b"
STEPS, SNAP = 5, 2
# case -> (optimizer, schedule, loss rtol, grad-norm rtol, final masters'
# relative L2); measured readings in the test's docstring
CASES = {
    "sgd-fp32": ("sgd", {}, 1e-5, 1e-5, 1e-5),
    "muon-fp32": ("muon", {}, 1e-4, 1e-4, 1e-4),
    "shampoo-fp32": ("shampoo", {}, 1e-4, 1e-4, 1e-4),
    "muon-q8_block": ("muon", {"param_store": "q8_block"}, 1e-4, 5e-4,
                      1e-3),
    "muon-bf16": ("muon", {"param_store": "bf16"}, 1e-4, 1e-4, 2e-4),
}


def _np(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _np(tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _master(state):
    return state["master"] if isinstance(state, dict) else state


def _jax_run(opt, sched, steps=STEPS):
    cfg = dataclasses.replace(jax_get_config(ARCH).reduced(), optimizer=opt,
                              learning_rate=W.LR)
    rt = JaxRuntime(jax_build_model(cfg), make_local_mesh(1, 1),
                    compute_dtype=jnp.float32, schedule=JaxSchedule(**sched))
    params = rt.init_params(0)
    o = jax_make_optimizer(cfg)
    state = o.init(rt)
    step_fn = rt.make_train_step(o)
    stream = JaxStream(JaxDataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
    step = jnp.int32(0)
    losses, norms, snap = [], [], None
    for i in range(steps):
        if i == SNAP:
            snap = (_np_tree(params), _np_tree(state))
        batch = stream.shard(stream.batch(i), rt)
        params, state, step, m = step_fn(params, state, step, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=np.asarray(losses), norms=np.asarray(norms),
                final=_np_tree(params), snap=snap)


@pytest.fixture(scope="module")
def refs():
    """The reference's runs, computed once per case."""
    cache = {}

    def get(case):
        if case not in cache:
            opt, sched = CASES[case][:2]
            cache[case] = _jax_run(opt, sched)
        return cache[case]

    return get


def _port_run(opt, sched, steps=STEPS, **kw):
    return W.train(init_local_group("gloo"), torch.float32, steps,
                   schedule=CommSchedule(**sched), arch=ARCH,
                   overrides=dict(optimizer=opt), **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_train_matches_reference(case, refs):
    """Five steps: loss and grad-norm streams and the final masters against
    the reference's.  Measured (loss rtol / grad-norm rtol / masters
    relative L2): SGD 1.2e-7 / 2.4e-7 / 1.0e-8; Muon fp32 1.2e-7 / 3.6e-7
    / 5.2e-7; Shampoo 1.2e-7 / 4.8e-7 / 8.3e-7; Muon bf16 3.5e-7 / 9.1e-6
    / 2.8e-5 (a master that straddles a bf16 rounding boundary rounds the
    other way); Muon q8_block 1.6e-6 / 1.1e-4 / 9.7e-5 -- 0.02-0.05% of the
    weight codes differ after five steps (a master within rounding of a
    code boundary), and the embedding rows and biases, whose Adam steps
    normalize near-zero gradients, carry it (1.9e-4 and up to 3.5e-3
    relative L2 on those tensors, under 5e-6 on the matrices).  Asserted:
    ``CASES``."""
    opt, sched, lt, nt, ft = CASES[case]
    ref = refs(case)
    losses, norms, rt, params, _ = _port_run(opt, sched)
    np.testing.assert_allclose(losses, ref["losses"], rtol=lt)
    np.testing.assert_allclose(norms, ref["norms"], rtol=nt)
    for name, want in ref["final"].items():
        got = _master(params[name]).detach().float().numpy()
        assert _rel(got, np.asarray(_master(want), np.float32)) < ft, name
    # the losses moved: the optimizer stepped
    assert losses[-1] != losses[0]


@pytest.mark.parametrize("store", ["fp32", "q8_block"])
def test_q8_store_turns_last_bit_noise_into_code_flips(store, monkeypatch):
    """The parity class of Muon on the q8_block store: three steps as
    ``chip_smoke.py``'s ``parity_optim`` runs them, once as they are and
    once with each Newton-Schulz output multiplied by ``1 + 1e-6 n``
    (n ~ N(0, 1)), the size of the sum-order differences between two
    devices' fp32 products.  On the fp32 store the streams and masters
    move by 6.0e-8 / 1.2e-7 (card vs CPU reads 1.19e-7 / 2.73e-7 on an
    H100); on the q8_block store 48 weight codes
    flip (a master within rounding of a code boundary requantizes the
    other way) and the streams and masters move by 7.1e-6 / 3.5e-5, as
    card vs CPU does there (7.5e-6 / 3.5e-5).  Asserted: the fp32 store
    within 3e-7; on the q8_block store some code flips and the streams
    and masters move by 1e-6-1e-4 / 1e-5-1e-3."""
    from repro_torch.optim.muon import Muon

    sched = {} if store == "fp32" else {"param_store": store}
    base = _port_run("muon", sched, steps=3)
    orthogonalize = Muon._orthogonalize
    gen = torch.Generator().manual_seed(5)

    def noisy(pl, mine):
        o = orthogonalize(pl, mine)
        return o * (1 + 1e-6 * torch.randn(o.shape, generator=gen))

    monkeypatch.setattr(Muon, "_orthogonalize", staticmethod(noisy))
    moved = _port_run("muon", sched, steps=3)
    streams = max(abs(a - b) / abs(b) for i in (0, 1)
                  for a, b in zip(moved[i], base[i]))
    masters = max(_rel(_np(_master(moved[3][n])), _np(_master(p)))
                  for n, p in base[3].items())
    if store == "fp32":
        assert streams <= 3e-7 and masters <= 3e-7, (streams, masters)
        return
    flips = sum(int((moved[3][n]["codes"] != p["codes"]).sum())
                for n, p in base[3].items())
    assert flips > 0
    assert 1e-6 <= streams <= 1e-4, streams
    assert 1e-5 <= masters <= 1e-3, masters


@pytest.mark.parametrize("case", ["muon-fp32", "shampoo-fp32"])
def test_load_reference_state(case, refs):
    """The reference's state after two steps (masters; ``mom``, ``m``,
    ``v`` and, for Shampoo, every factor ``(Lp, k, k)``) carried into the
    port: every leaf bitwise, and three more steps match the reference's
    steps three to five within the five-step bounds (measured loss / norm
    rtol: Muon 1.2e-7 / 4.8e-7, Shampoo 1.8e-7 / 2.4e-7).  A factor of the wrong
    shape and a missing factor raise."""
    opt, sched, lt, nt, _ = CASES[case]
    ref = refs(case)
    params_np, opt_np = ref["snap"]

    def state(rt):
        params, opt_state = load_reference_state(rt, params_np, opt_np)
        for k, leaves in opt_np.items():
            assert sorted(opt_state[k]) == sorted(leaves)
            for n, want in leaves.items():
                assert np.array_equal(opt_state[k][n].numpy(), want)
        return params, opt_state

    losses, norms, rt, _, _ = _port_run(opt, sched, STEPS - SNAP,
                                        first_step=SNAP, state=state)
    np.testing.assert_allclose(losses, ref["losses"][SNAP:], rtol=lt)
    np.testing.assert_allclose(norms, ref["norms"][SNAP:], rtol=nt)
    if opt != "shampoo":
        return
    bad = {k: dict(v) for k, v in opt_np.items()}
    key = sorted(bad["factors"])[0]
    bad["factors"][key] = bad["factors"][key][:, :-1]
    with pytest.raises(ValueError, match="layout needs"):
        load_reference_state(rt, params_np, bad)
    del bad["factors"][key]
    with pytest.raises(ValueError, match="do not match"):
        load_reference_state(rt, params_np, bad)


def _spawn(tmp_path, world, steps, overrides):
    ctx = multiprocessing.get_context("spawn")
    prefix = str(tmp_path / f"w{world}_rank")
    procs = [ctx.Process(target=OW.rank_main,
                         args=(r, world, str(tmp_path / f"store{world}"),
                               prefix, steps, ARCH, overrides))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks {alive} did not finish"
    assert [p.exitcode for p in procs] == [0] * world
    return [dict(np.load(f"{prefix}{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("opt", ["muon", "shampoo"])
def test_ranks_track_one_rank(opt, world, tmp_path):
    """qwen2.5-14b reduced at 3 layers on ``world`` gloo ranks against one
    rank, three steps (fp32, fp32 store).  Each rank gathers the momentum
    (Muon) or gradient (Shampoo) along the shard axis, preconditions its
    ``ceil(3 / world)`` whole layers (on 4 ranks the fourth layer is the
    padding, which rank 3 preconditions as zeros) and gathers the results
    back; what differs from one rank is the order of the gradient sums.
    The key bias ``wk_b`` is the exception: its gradient is zero in exact
    arithmetic (it shifts each query's logits by one constant, which the
    softmax cancels), so the Adam fallback normalizes rounding noise there
    and the tensor is noise of the step's size on either run.  Measured:
    loss rtol up to 3.6e-7, grad-norm 6.0e-7, tensors relative L2 up to
    1.4e-5 (``wk_b`` 2.3e-3), Shampoo's factors 1.9e-5 (the padded layer's
    exactly zero).  Asserted: 1e-5, 1e-5, 1e-4 (``wk_b`` 1e-2), 1e-4."""
    steps = 3
    overrides = dict(optimizer=opt, n_layers=3)
    outs = _spawn(tmp_path, world, steps, overrides)
    losses, norms, rt, params, state = W.train(
        init_local_group("gloo"), torch.float32, steps, arch=ARCH,
        overrides=overrides)
    for out in outs:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["norms"], norms, rtol=1e-5)
    multi = plan(rt.model, {"data": world, "model": 1})
    for name, lo in rt.layouts.items():
        buf = np.concatenate([o[f"param/{name}"] for o in outs], axis=-1)
        dbm = DBuffer(multi.groups[name].plan)
        full = params[name].detach().numpy()
        for i in range(lo.n_layers or 1):
            got = dbm.unpack_np(buf[i] if lo.n_layers else buf)
            want = lo.buffer.unpack_np(full[i] if lo.n_layers else full)
            for t in want:
                bound = 1e-2 if t == "wk_b" else 1e-4
                assert _rel(got[t], want[t]) < bound, (name, i, t)
    if opt != "shampoo":
        return
    L = 3
    for key, t in state["factors"].items():
        rows = np.concatenate([o[f"state/factors/{key}"] for o in outs])
        assert rows.shape[0] == -(-L // world) * world
        assert _rel(rows[:L], t.numpy()) < 1e-4, key
        assert not rows[L:].any(), key
