"""The ring routes of the port's wire on 2 and 4 gloo ranks against the
reference's on as many host devices (a JAX subprocess with 4 of them), on
the same numpy inputs: the ring all-gather (fp32 and bf16), the
order-exact ring reduce-scatter and the accumulate-in-flight ``ring_acc``
of the fp32 and bf16 cast codecs, and the q8_block codec's match routes
(all-to-all and ring) and its ring_acc, each with shard-sized messages and
at a fixed ``ring_chunk_elems``; and the one-rank edge (no peers: the
reference's n = 1 result, never another route).

Parity class: BITWISE -- the gathers are data movement; the match routes
sum in fp32 in rank order and ring_acc in ring order, as the reference's
routes do; the q8 codes and scales come from the ported ``quantize``,
bitwise its reference.  Two exceptions, read from the reference's outputs
(XLA:CPU's compilation, not its source):

  * bf16 ring_acc: XLA drops the bf16 rounding of the last hop's add (its
    result feeds the cast to fp32, and XLA allows excess precision there;
    with ``ring_chunk`` the concatenation keeps it), while the port rounds
    every add to bf16 as the source says -- held BITWISE against the
    reference's output rounded to bf16;
  * q8 ring_acc: XLA contracts the received partial's dequantize and the
    add into one FMA (an f64 emulation of ``fma(codes, scale,
    round(local))`` reproduces its bits), while the port rounds both
    products as the source says -- ALLCLOSE: measured relative L2 2.8e-8
    (2 ranks, 108 of 4,096 elements differ) and 4.3e-8 (4 ranks, 593,
    the requantize between hops carrying some flips); asserted 2e-7.  The
    same class as AdamW's FMA (ROADMAP Queue 3).
"""
import multiprocessing
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_ring_worker as RW
from repro_torch.core import wire
from repro_torch.launch.mesh import init_local_group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_XLA_ROUTES = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, sys.argv[2])
    from repro.compat import make_mesh, shard_map
    from repro.core.wire import (WireCodec, codec_reduce_scatter,
                                 payload_all_gather)
    import _torch_ring_worker as RW
    out = {}
    for world in (2, 4):
        mesh = make_mesh((world,), ("data",), devices=jax.devices()[:world])
        ax, sz = ("data",), (world,)

        def run(f, x):
            return np.asarray(jax.jit(shard_map(
                lambda v: f(v[0])[None], mesh=mesh, in_specs=P("data"),
                out_specs=P("data")))(x))

        x = RW.route_inputs(world)
        for name, fmt, mode, rmode, chunk in RW.ROUTE_CASES:
            codec = WireCodec(fmt, RW.Q8_BLOCK)
            out[f"{name}_{world}"] = run(
                lambda ct: codec_reduce_scatter(
                    ct, None, codec, ax, sz, mode, rmode, jnp.float32,
                    chunk)[0], x)
        s = RW.shard_inputs(world)
        for chunk in (None, RW.RING_CHUNK // 4):
            out[f"gather_{chunk}_{world}"] = run(
                lambda v: payload_all_gather(v, ax, sz, "ring", chunk), s)
            out[f"gather_bf16_{chunk}_{world}"] = run(
                lambda v: payload_all_gather(
                    v.astype(jnp.bfloat16), ax, sz, "ring",
                    chunk).astype(jnp.float32), s)
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def xla_routes(tmp_path_factory):
    d = tmp_path_factory.mktemp("xla_ring")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run([sys.executable, "-c", _XLA_ROUTES,
                    os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
                    str(d / "out.npz")], check=True, env=env, timeout=300)
    return dict(np.load(d / "out.npz"))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _spawn(target, world, tmp_path, *args, timeout=120):
    ctx = multiprocessing.get_context("spawn")
    prefix = str(tmp_path / "rank")
    procs = [ctx.Process(target=target,
                         args=(r, world, str(tmp_path / "store"), prefix)
                         + args)
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks {alive} did not finish"
    assert [p.exitcode for p in procs] == [0] * world
    return [dict(np.load(f"{prefix}{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_ring_routes_match_reference(world, xla_routes, tmp_path):
    outs = _spawn(RW.routes_main, world, tmp_path)
    for name, fmt, _, rmode, _ in RW.ROUTE_CASES:
        want = xla_routes[f"{name}_{world}"]
        if fmt == "bf16" and rmode == "ring_acc":
            want = torch.from_numpy(want).bfloat16().float().numpy()
        if fmt == "q8_block" and rmode == "ring_acc":
            got = np.stack([o[name] for o in outs])
            assert got.shape == want.shape
            assert _rel_l2(got, want) < 2e-7, name
            continue
        for r in range(world):
            got = outs[r][name]
            assert got.shape == want[r].shape, name
            assert np.array_equal(got.view(np.int32),
                                  want[r].view(np.int32)), (name, r)
    for chunk in (None, RW.RING_CHUNK // 4):
        for key in (f"gather_{chunk}", f"gather_bf16_{chunk}"):
            want = xla_routes[f"{key}_{world}"]
            for r in range(world):
                assert np.array_equal(outs[r][key], want[r]), (key, r)
    # ring_acc is another sum order than the match routes: close, and
    # (measured) not everywhere bitwise
    for fmt in ("fp32", "q8_block"):
        a = outs[0][f"{fmt}_ring_ring_acc_None"]
        b = outs[0][f"{fmt}_ring_match_None"]
        np.testing.assert_allclose(a, b, rtol=0.05, atol=1e-2 * np.abs(
            b).max())


def test_snap_chunk_matches_reference():
    from repro.core.wire import _snap_chunk as jax_snap

    for rows in (1, 7, 64, 1000, 4096, 6144):
        for chunk in (None, 1, 3, 64, 100, 256, 5000):
            for unit in (1, 64):
                assert wire._snap_chunk(rows, chunk, unit) == \
                    jax_snap(rows, chunk, unit), (rows, chunk, unit)


def test_ring_routes_on_one_rank():
    """No peers: the ring gather returns the shard itself and every
    reduce route the reference's n = 1 result (a cast round trip; a q8
    encode and decode) -- no collective, no other route."""
    from repro.core.wire import WireCodec as JaxCodec
    from repro.core.wire import codec_reduce_scatter as jax_rs
    import jax.numpy as jnp

    group = init_local_group("gloo")
    x = RW.route_inputs(1)[0]
    assert torch.equal(wire.payload_all_gather(torch.from_numpy(x), group,
                                               "ring"), torch.from_numpy(x))
    for name, fmt, mode, rmode, chunk in RW.ROUTE_CASES:
        got = wire.codec_reduce_scatter(
            torch.from_numpy(x), None, wire.WireCodec(fmt, RW.Q8_BLOCK),
            group, torch.float32, mode, rmode, chunk).numpy()
        want, _ = jax_rs(jnp.asarray(x), None, JaxCodec(fmt, RW.Q8_BLOCK),
                         (), (), mode, rmode, jnp.float32, chunk)
        assert np.array_equal(got.view(np.int32),
                              np.asarray(want).view(np.int32)), name
