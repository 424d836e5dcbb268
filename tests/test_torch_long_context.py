"""RoPE and the ``long_500k`` decode (524,288 positions, batch 1) against
the JAX reference, at the positions the published shapes reach.

  * ``rope_freqs``: BITWISE the reference's frequency vector for every
    ``(rope_theta, hd)`` of the port's configs, published and reduced (the
    list is read from ``repro_torch.configs``).  The reference computes it
    inside a jitted step, where XLA rewrites ``/ half`` as ``* fp32(1 /
    half)`` (different bits at nemotron-4-340b's hd 192 than an eager
    ``/``) and takes a correctly rounded fp32 ``pow``.  The parent port's
    fp32 ``torch.pow`` read 2-5 differing frequencies a pair (34 of 96 at
    hd 192).
  * ``rope``: ALLCLOSE at positions 0, 4,095, 32,767 and 524,287 with
    unit-normal x: the angles are bitwise, torch's fp32 ``cos``/``sin``
    are not XLA:CPU's, so about 27% of the elements past position 0 differ,
    by up to 4.8e-7 (8 x 16 rows a position, every pair).  Bound 2e-6
    absolute.  The parent port read up to 4.4e-2 at (1e4, 256),
    gemma2-2b's, and 1.2e-2 at (1e6, 128) at 524,287 (llama3's (5e5, *)
    had no differing frequency and read as now).
  * the ``long_500k`` decode of gemma2-2b and hymba-1.5b (``.reduced()``,
    2 layers, fp32 store and compute; both cap every layer's cache at
    their window, 16 slots reduced, past 65,536 positions): from an empty
    ``init_cache(1, 524_288)``, 16 decode steps ending at index 524,287
    (``end``: the ring filled at the shape's last positions) and 16 steps
    from index 524,264 (``wrap``: the ring's slot wraps at 524,272).
    Each step's logits within relative L2 ``LONG_BOUND`` = 5e-4, inside
    the serve class of tests/test_torch_serve.py and
    tests/test_torch_recurrent.py (1.5e-3: a bf16 KV cache entry within
    rounding of a midpoint rounds the other way).  Reads (end / wrap)
    1.5e-5 / 1.7e-4 (gemma2-2b) and 3.1e-5 / 1.7e-5 (hymba-1.5b); the
    parent port's rope read 8.9e-4 / 1.2e-3 and 7.3e-4 / 9.9e-4, so the
    bound sits between the sound reading and the fault's.  The caches'
    positions are bitwise the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.launch.mesh import make_local_mesh
from repro.models import layers as JL

from _torch_ref_step import placed_cache
from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.core.fsdp import FSDPRuntime
from repro_torch.launch.mesh import init_local_group
from repro_torch.models import layers as TL

torch.set_num_threads(2)

POSITIONS = (0, 4095, 32767, 524287)
ROPE_ATOL = 2e-6
SEQ = 524_288                     # SHAPES["long_500k"].seq_len
STEPS = 16
STRETCHES = {"end": SEQ - STEPS, "wrap": SEQ - 24}
LONG_BOUND = 5e-4


def _rope_pairs():
    """Every (rope_theta, hd) of the port's configs, published and
    reduced."""
    cfgs = [get_config(a) for a in ARCH_IDS]
    return sorted({(c.rope_theta, c.hd) for c in cfgs}
                  | {(c.reduced().rope_theta, c.reduced().hd) for c in cfgs})


PAIRS = _rope_pairs()


def _pair_id(pair):
    return f"{pair[0]:g}-{pair[1]}"


def _reference_freqs(theta, hd):
    """The reference's frequency vector as its jitted steps compute it:
    ``models/layers.py:94`` under ``jax.jit``, multiplied by position 1
    (exact), so that XLA compiles it as it does beside traced positions."""
    half = hd // 2

    def ang(p):
        freqs = theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
        return p.astype(jnp.float32)[:, None] * freqs

    return np.asarray(jax.jit(ang)(jnp.ones((1,), jnp.int32)))[0]


@pytest.mark.parametrize("pair", PAIRS, ids=_pair_id)
def test_rope_freqs_are_the_reference_bits(pair):
    theta, hd = pair
    want = _reference_freqs(theta, hd)
    got = TL.rope_freqs(hd // 2, theta).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
        np.flatnonzero(got != want)


@pytest.mark.parametrize("pair", PAIRS, ids=_pair_id)
def test_rope_matches_reference_at_long_positions(pair):
    theta, hd = pair
    x = np.random.default_rng(hd).standard_normal(
        (2, 4, len(POSITIONS), hd)).astype(np.float32)
    pos = np.broadcast_to(np.asarray(POSITIONS, np.int32),
                          (2, len(POSITIONS))).copy()
    want = np.asarray(jax.jit(lambda a, p: JL.rope(a, p, theta))(x, pos))
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    err = np.abs(got - want).max(axis=(0, 1, 3))
    assert err.max() < ROPE_ATOL, dict(zip(POSITIONS, err))


# ---------------------------------------------------------------------------
# the long_500k decode
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def group():
    return init_local_group("gloo")


@pytest.fixture(scope="module")
def served(group):
    """arch -> (port runtime, params, reference model, runtime, params)."""
    out = {}
    for arch in ("gemma2-2b", "hymba-1.5b"):
        rt = FSDPRuntime(build_model(get_config(arch).reduced()), group,
                         compute_dtype=torch.float32, device="cpu")
        jm = jax_build_model(jax_get_config(arch).reduced())
        jrt = JaxRuntime(jm, make_local_mesh(1, 1), compute_dtype=jnp.float32)
        out[arch] = (rt, rt.init_params(0), jm, jrt, jrt.init_params(0))
    return out


@pytest.mark.parametrize("stretch", list(STRETCHES))
@pytest.mark.parametrize("arch", ["gemma2-2b", "hymba-1.5b"])
def test_long_500k_decode_matches_reference(arch, stretch, served):
    rt, params, jm, jrt, jparams = served[arch]
    first = STRETCHES[stretch]
    toks = np.random.default_rng(first).integers(0, rt.cfg.vocab,
                                                 (1, STEPS))
    cache = rt.init_cache(1, SEQ)
    jcache = placed_cache(jrt, jm.init_cache(1, SEQ), 1)
    window = rt.model.cache_window(SEQ)
    assert window == jm.cache_window(SEQ) == rt.cfg.sliding_window
    decode, jdecode = rt.make_decode_step(), jrt.make_decode_step()
    errs = []
    for i in range(STEPS):
        lg, cache = decode(params, {"tokens": torch.from_numpy(
            toks[:, i:i + 1])}, cache, first + i)
        jlg, jcache = jdecode(jparams, {"tokens": jnp.asarray(
            toks[:, i:i + 1], jnp.int32)}, jcache, jnp.int32(first + i))
        assert lg.shape == (1, 1, rt.cfg.vocab)
        assert np.isfinite(lg.numpy()).all()
        errs.append(_rel(lg.numpy(), np.asarray(jlg, np.float32)))
    assert max(errs) < LONG_BOUND, errs
    slots = (np.arange(first, first + STEPS) % window)
    assert (stretch == "wrap") == bool((np.diff(slots) < 0).any())
    pos = cache["pos"] if "pos" in cache else cache["attn"]["pos"]
    jpos = jcache["pos"] if "pos" in jcache else jcache["attn"]["pos"]
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
