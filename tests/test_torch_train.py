"""The port's ZeRO-3 train step against the JAX reference: the quickstart
loop (gemma2-2b.reduced(), batch 8 x 64, AdamW with the learning rate
raised to 1e-2) for five steps on one rank, in fp32 and bf16 compute; a
two-rank gloo run against the one-rank run; carrying a reference state
across; and the package rules (device default, no JAX imports).

Parity class: ALLCLOSE, bounds measured and stated per test.  Adam's first
steps map g to about sign(g), so elements whose gradient is near zero can
flip across frameworks: masters are compared by relative L2 distance, not
elementwise.
"""
import multiprocessing
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import build_model as jax_build_model
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticStream as JaxStream
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer as jax_make_optimizer

import _torch_train_worker as W
from repro_torch.configs import build_model
from repro_torch.core.fsdp import FSDPRuntime, load_reference_state
from repro_torch.launch.mesh import init_local_group

torch.set_num_threads(2)

STEPS, SNAP = 5, 3
REPO = Path(__file__).resolve().parents[1]


def _jax_run(dtype):
    """Five reference steps; snapshots (params, m, v) after SNAP steps."""
    import dataclasses
    from repro.configs import get_config

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              learning_rate=W.LR)
    rt = JaxRuntime(jax_build_model(cfg), make_local_mesh(1, 1),
                    compute_dtype=dtype)
    params = rt.init_params(0)
    opt = jax_make_optimizer(cfg)
    state = opt.init(rt)
    step_fn = rt.make_train_step(opt)
    stream = JaxStream(JaxDataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
    step = jnp.int32(0)
    losses, norms, snap = [], [], None
    for i in range(STEPS):
        if i == SNAP:
            snap = ({k: np.asarray(v) for k, v in params.items()},
                    {s: {k: np.asarray(v) for k, v in state[s].items()}
                     for s in ("m", "v")})
        batch = stream.shard(stream.batch(i), rt)
        params, state, step, m = step_fn(params, state, step, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = {k: np.asarray(v) for k, v in params.items()}
    return dict(losses=np.asarray(losses), norms=np.asarray(norms),
                final=final, snap=snap)


@pytest.fixture(scope="module")
def ref_fp32():
    return _jax_run(jnp.float32)


@pytest.fixture(scope="module")
def port_fp32():
    losses, norms, _, params, _ = W.train(init_local_group("gloo"),
                                          torch.float32, STEPS)
    return dict(losses=np.asarray(losses), norms=np.asarray(norms),
                final={k: p.detach().numpy() for k, p in params.items()})


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _delta_rel_l2(got, want, start):
    """Relative L2 distance of the two runs' total weight updates."""
    return _rel_l2(np.asarray(got, np.float64) - start,
                   np.asarray(want, np.float64) - start)


def test_train_fp32_matches_reference(ref_fp32, port_fp32):
    """Measured: loss stream within rtol 4e-7, grad-norm stream within
    1.7e-6; final masters within relative L2 6.3e-6 (globals) and 9.4e-7
    (layers), their five-step updates within 5.3e-4.  Asserted: rtol 1e-4
    on the streams, 5e-5 on the masters, 1e-2 on the updates."""
    np.testing.assert_allclose(port_fp32["losses"], ref_fp32["losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(port_fp32["norms"], ref_fp32["norms"],
                               rtol=1e-4)
    start = _initial_masters()
    for name, want in ref_fp32["final"].items():
        got = port_fp32["final"][name]
        assert _rel_l2(got, want) < 5e-5, name
        assert _delta_rel_l2(got, want, start[name]) < 1e-2, name


def test_train_bf16_matches_reference():
    """bf16 compute, bf16 gather wire and bf16 gradient reduce-scatter in
    both packages.  Measured: loss rtol 3.9e-4, grad-norm rtol 4.4e-3,
    masters within relative L2 1.1e-3, master updates within 8.5e-2.
    Asserted: 5e-3, 3e-2, 1e-2 and 0.2."""
    ref = _jax_run(jnp.bfloat16)
    losses, norms, _, params, _ = W.train(init_local_group("gloo"),
                                          torch.bfloat16, STEPS)
    np.testing.assert_allclose(losses, ref["losses"], rtol=5e-3)
    np.testing.assert_allclose(norms, ref["norms"], rtol=3e-2)
    start = _initial_masters()
    for name, want in ref["final"].items():
        got = params[name].detach().numpy()
        assert _rel_l2(got, want) < 1e-2, name
        assert _delta_rel_l2(got, want, start[name]) < 0.2, name


def _initial_masters():
    rt = FSDPRuntime(build_model(W.quickstart_config()),
                     init_local_group("gloo"), device="cpu")
    return {k: p.detach().numpy().astype(np.float64)
            for k, p in rt.init_params(0).items()}


def test_two_ranks_match_one_rank(tmp_path, port_fp32):
    """Two gloo ranks: each holds half of every group's columns, its own
    weight-decay mask and half the batch; the gathers and reduce-scatters
    cross ranks.  Measured vs the one-rank run: streams within rtol 9e-8,
    masters within relative L2 7.2e-8.  Asserted: 1e-5 and 1e-6."""
    ctx = multiprocessing.get_context("spawn")
    init_file = str(tmp_path / "store")
    prefix = str(tmp_path / "rank")
    procs = [ctx.Process(target=W.rank_main,
                         args=(r, 2, init_file, prefix, STEPS))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks {alive} did not finish"
    assert [p.exitcode for p in procs] == [0, 0]
    outs = [np.load(f"{prefix}{r}.npz") for r in range(2)]
    for o in outs:
        np.testing.assert_allclose(o["losses"], port_fp32["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(o["norms"], port_fp32["norms"], rtol=1e-5)
    for name, want in port_fp32["final"].items():
        got = np.concatenate([o[name] for o in outs], axis=-1)
        assert got.shape == want.shape
        assert _rel_l2(got, want) < 1e-6, name


def test_load_reference_state_round_trip(ref_fp32):
    """A reference state after three steps, carried into the port: the
    placed shards equal it bitwise, and two more steps from it match the
    reference's steps four and five (rtol 1e-4, masters relative L2
    5e-5, the bounds of the five-step test)."""
    params_np, opt_np = ref_fp32["snap"]

    def state(rt):
        params, opt_state = load_reference_state(rt, params_np, opt_np)
        for name in params_np:
            assert np.array_equal(params[name].detach().numpy(),
                                  params_np[name])
            for k in ("m", "v"):
                assert np.array_equal(opt_state[k][name].numpy(),
                                      opt_np[k][name])
        assert params["layers"].requires_grad
        return params, opt_state

    losses, norms, rt, params, _ = W.train(
        init_local_group("gloo"), torch.float32, STEPS - SNAP,
        first_step=SNAP, state=state)
    np.testing.assert_allclose(losses, ref_fp32["losses"][SNAP:], rtol=1e-4)
    np.testing.assert_allclose(norms, ref_fp32["norms"][SNAP:], rtol=1e-4)
    for name, want in ref_fp32["final"].items():
        assert _rel_l2(params[name].detach().numpy(), want) < 5e-5
    bad = dict(params_np)
    bad["globals"] = bad["globals"][:-128]
    with pytest.raises(ValueError, match="layout needs"):
        load_reference_state(rt, bad)
    with pytest.raises(ValueError, match="do not match"):
        load_reference_state(rt, {"layers": params_np["layers"]})


def test_runtime_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FSDPRuntime(build_model(W.quickstart_config()),
                    init_local_group("gloo"))


def test_unported_runtime_options_raise():
    import dataclasses

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import make_optimizer

    cfg = W.quickstart_config()
    group = init_local_group("gloo")
    # a pod axis is ported (HSDP), and Muon and Shampoo on groups
    # replicated over it (their whole-matrix gathers run over the groups'
    # FSDP axes; tests/test_torch_tp_optim.py)
    mesh = make_local_mesh(1, 1, pod=1)
    assert mesh.axis_sizes == {"pod": 1, "data": 1, "model": 1}
    rt = FSDPRuntime(build_model(cfg), mesh, device="cpu")
    assert rt.has_pod and rt.batch_axes[0] == "pod"
    for opt in ("muon", "shampoo"):
        state = make_optimizer(dataclasses.replace(cfg, optimizer=opt)) \
            .init(rt)
        assert {"mom", "m", "v"} <= set(state), opt
    # replan onto and across a model axis is ported; onto more ranks than
    # the process group holds it is not
    rt = FSDPRuntime(build_model(cfg), group, device="cpu", policies="auto")
    with pytest.raises(ValueError, match="stays on the runtime's process"):
        rt.replan(rt.init_params(0), mesh={"data": 1, "model": 2})


_FORBIDDEN = re.compile(
    r"^\s*(import jax\b|from jax\b|import repro(\.|\s*$)|from repro[. ])",
    re.M)


def test_port_imports_no_jax_and_no_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    smoke = REPO / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    assert len(files) > 10
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits


def test_cpu_train_step_is_bitwise_repeatable():
    """``launch/repeatability.py``'s set-up (gemma2-2b.reduced(), fp32,
    two steps) gives the same loss and grad norm bit for bit on every
    run of a seed: the card-vs-CPU parity checks read the CPU run as
    their reference."""
    from repro_torch.launch import repeatability as R

    got = R.streams("gemma2-2b", "cpu", [0, 1], reps=2)
    for seed, runs in got.items():
        assert R.summary(runs) == {"distinct": 1, "max_rel_diff": 0.0}, seed
