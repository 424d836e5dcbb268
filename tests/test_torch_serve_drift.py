"""How far the int8 serve mode drifts from the dense q8 serve, by depth, in
the port and in the JAX reference.

gemma2-2b.reduced() at 1, 2 and 4 layers on the q8_block store, fp32
compute, parameters from seed 0 and prompts from one numpy seed in both
packages.  In each package the prefill logits of the int8 mode
(``serve_quant_matmul``: every eligible weight through ``q8_matmul``, the
activations quantized per row) are held against the dense-dequant q8
serve's.  The int8 mode adds error by design; what the port must not add is
drift of its own: at every depth its gap stays within ``GAP_RTOL`` of the
reference's gap, and both stay under the reference's own limit of 0.15
(``tests/test_torch_serve.py`` QUANT_VS_DENSE).

Readings (relative L2 of int8 against dense, port / reference): depth 1
0.03161 / 0.03161, depth 2 0.04261 / 0.04257, depth 4 0.08160 / 0.08213
(and 0.1487 / 0.1569 at 8 layers): the reference's gap grows with depth as
the port's does, so the growth is the int8 mode's, not a fault of the
port.  The two gaps differ by up to 0.64% of the reference's because the
int8 mode is discontinuous: input noise of 1e-7 relative at every
``q8_matmul`` call moves the port's own int8 logits by 1.3e-2 (code flips
at rounding boundaries, amplified through the layers), and the two
packages' dense paths differ by 1e-6-1e-4 before quantization.  GAP_RTOL
is 5% of the reference's gap, about eight times the largest reading.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.core.schedule import CommSchedule as JaxSchedule
from repro.launch.mesh import make_local_mesh

from repro_torch.configs import build_model, get_config
from repro_torch.core.fsdp import FSDPRuntime
from repro_torch.core.schedule import CommSchedule
from repro_torch.launch.mesh import init_local_group

torch.set_num_threads(2)

ARCH = "gemma2-2b"
MODES = {"int8": {"param_store": "q8_block", "serve_quant_matmul": True},
         "dense": {"param_store": "q8_block"}}
B, P, S = 2, 16, 32
QUANT_VS_DENSE = 0.15     # the reference's own check
GAP_RTOL = 0.05           # port gap vs reference gap, relative


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def group():
    return init_local_group("gloo")


def _port_prefill(layers, mode, toks, group):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=layers)
    model = build_model(cfg)
    rt = FSDPRuntime(model, group, compute_dtype=torch.float32, device="cpu",
                     schedule=CommSchedule(**MODES[mode]))
    params = rt.init_params(0)
    cache = model.init_cache(B, S, device="cpu")
    lg, _ = rt.make_prefill_step()(params, {"tokens": torch.from_numpy(toks)},
                                   cache)
    return lg.numpy()


def _jax_prefill(layers, mode, toks):
    cfg = dataclasses.replace(jax_get_config(ARCH).reduced(), n_layers=layers)
    model = jax_build_model(cfg)
    rt = JaxRuntime(model, make_local_mesh(1, 1), compute_dtype=jnp.float32,
                    schedule=JaxSchedule(**MODES[mode]))
    params = rt.init_params(0)
    lg, _ = rt.make_prefill_step()(params, {"tokens": jnp.asarray(
        toks, jnp.int32)}, model.init_cache(B, S))
    return np.asarray(lg, np.float32)


@pytest.mark.parametrize("layers", (1, 2, 4))
def test_int8_drift_by_depth_matches_reference(layers, group):
    toks = np.random.default_rng(7).integers(
        0, get_config(ARCH).reduced().vocab, (B, P))
    port = {m: _port_prefill(layers, m, toks, group) for m in MODES}
    ref = {m: _jax_prefill(layers, m, toks) for m in MODES}
    port_gap = _rel(port["int8"], port["dense"])
    ref_gap = _rel(ref["int8"], ref["dense"])
    assert 0 < ref_gap < QUANT_VS_DENSE, ref_gap
    assert 0 < port_gap < QUANT_VS_DENSE, port_gap
    assert abs(port_gap - ref_gap) <= GAP_RTOL * ref_gap, (port_gap, ref_gap)
