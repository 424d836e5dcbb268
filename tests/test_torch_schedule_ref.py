"""Each of the reference's named schedules in the port against the same
schedule in the reference: gemma2-2b.reduced(), fp32 compute, five
quickstart steps on one rank (one host device).

Parity class: ALLCLOSE, within the bounds tests/test_torch_train.py states
for the default schedule (loss and grad-norm rtol 1e-4, final masters
within relative L2 5e-5, their five-step updates within 1e-2).  Measured
over three runs of every variant: loss within rtol 4.0e-7 to 6.0e-7, grad
norm 2.0e-6 to 2.2e-6, masters within relative L2 6.3e-6; once, the
reference's default read 4.7e-6, 9.9e-6 and 3.0e-5 (its next runs read
as above; the port's runs repeat bitwise).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.core.schedule import VARIANTS as JAX_VARIANTS
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticStream as JaxStream
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer as jax_make_optimizer

import _torch_train_worker as W
from _torch_ref_step import first_step
from repro_torch.core.schedule import VARIANTS
from repro_torch.launch.mesh import init_local_group

torch.set_num_threads(2)

STEPS = 5


def _jax_run(sched):
    cfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                              learning_rate=W.LR)
    rt = JaxRuntime(jax_build_model(cfg), make_local_mesh(1, 1),
                    compute_dtype=jnp.float32, schedule=sched, donate=False)
    params = rt.init_params(0)
    opt = jax_make_optimizer(cfg)
    state = opt.init(rt)
    step_fn = rt.make_train_step(opt)
    stream = JaxStream(JaxDataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
    step = first_step(rt)
    out = []
    for i in range(STEPS):
        params, state, step, m = step_fn(params, state, step,
                                         stream.shard(stream.batch(i), rt))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return np.asarray(out), {k: np.asarray(v) for k, v in params.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def start():
    _, _, rt, params, _ = W.train(init_local_group("gloo"), torch.float32, 0)
    return {k: p.detach().numpy().astype(np.float64)
            for k, p in params.items()}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_reference_variant(name, start):
    ref, ref_final = _jax_run(JAX_VARIANTS[name])
    losses, norms, _, params, _ = W.train(init_local_group("gloo"),
                                          torch.float32, STEPS,
                                          schedule=VARIANTS[name])
    np.testing.assert_allclose(losses, ref[:, 0], rtol=1e-4)
    np.testing.assert_allclose(norms, ref[:, 1], rtol=1e-4)
    for k, want in ref_final.items():
        got = params[k].detach().numpy()
        assert _rel_l2(got, want) < 5e-5, k
        assert _rel_l2(got - start[k], want - start[k]) < 1e-2, k
