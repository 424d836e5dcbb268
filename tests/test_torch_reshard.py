"""Resharding in the port against the JAX reference: the per-tensor shard
index (``core.reshard``), the offline tool (``repro_torch.tools.reshard``)
and ``FSDPRuntime.replan``.

  * extents equal the reference's under every planner and tile the packed
    buffer exactly; ``copy_tensor`` moves what the reference's moves;
  * the tool's identity run copies every file byte for byte; across
    planners, world sizes and store formats its output files are
    byte-identical to the reference tool's on the same checkpoint;
  * a reference checkpoint saved on 8 host devices (a JAX subprocess),
    resharded 8 -> 2 by the port's tool, resumes on 2 gloo ranks;
  * ``replan`` in the job (fp32 -> q8_block store with the q8 gradient
    wire, ragged -> fsdp2, ``policies="auto"``) gives every leaf a save
    and load through a checkpoint would (across two ranks:
    tests/test_torch_ckpt_optim.py); 8-bit Adam state reshards through the
    tool on the aligned path.

Parity class: BITWISE (extents, files, leaves) except the resumed step's
loss against the reference's (ALLCLOSE, stated in the test).
"""
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import planner as jax_planner
from repro.core import policy as jax_policy
from repro.core import reshard as jax_reshard
from repro.core.dbuffer import DBuffer as JaxDBuffer
from repro.core.ragged import TensorSpec as JaxSpec
from repro.core.schedule import CommSchedule as JaxSchedule
from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config

import _torch_ckpt_worker as CW
import _torch_train_worker as W
from repro_torch.checkpoint import ckpt
from repro_torch.configs import build_model, get_config
from repro_torch.core import planner
from repro_torch.core.dbuffer import DBuffer
from repro_torch.core.fsdp import FSDPRuntime
from repro_torch.core.policy import plan as make_plan
from repro_torch.core.ragged import Extent, TensorSpec
from repro_torch.core.reshard import GroupIndex, buffer_reader, copy_tensor
from repro_torch.core.schedule import CommSchedule
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_local_group
from repro_torch.optim import make_optimizer
from repro_torch.tools import reshard as tool

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
SEQ, BATCH = 16, 4
Q8 = {"param_store": "q8_block", "reduce_wire": "q8_block"}

SPECS = [("a", (7, 96), 96), ("b", (384,), 1), ("c", (13, 64), 64),
         ("d", (5,), 1)]
PLANNERS = {"ragged": dict(g_coll=128, align=32), "naive": {},
            "megatron": {}, "fsdp2": {}}


def _plan(pkg, name, m):
    spec_t = TensorSpec if pkg is planner else JaxSpec
    specs = [spec_t(n, s, granularity=g) for n, s, g in SPECS]
    fn = {"ragged": pkg.plan_group, "naive": pkg.plan_naive,
          "megatron": pkg.plan_megatron, "fsdp2": pkg.plan_fsdp2}[name]
    return fn(specs, m, **PLANNERS[name])


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("name", list(PLANNERS))
def test_extent_map_matches_reference_and_packing(name, m):
    """Each tensor's extents equal the reference's and address exactly the
    elements ``DBuffer.pack`` put there."""
    ours, ref = _plan(planner, name, m), _plan(jax_planner, name, m)
    buf = DBuffer(ours)
    arrays = {n: np.arange(np.prod(s), dtype=np.float32).reshape(s) * (i + 1)
              for i, (n, s, _) in enumerate(SPECS)}
    shards = buf.pack(arrays).reshape(m, ours.shard_size)
    for n, s, _ in SPECS:
        exts = ours.tensor_extents(n)
        assert [tuple(dataclasses.astuple(e)) for e in exts] == \
            [tuple(dataclasses.astuple(e)) for e in ref.tensor_extents(n)]
        got = np.empty(int(np.prod(s)), np.float32)
        for e in exts:
            got[e.tensor_lo:e.tensor_lo + e.size] = shards[e.shard][e.lo:e.hi]
        assert sum(e.size for e in exts) == got.size
        np.testing.assert_array_equal(got, arrays[n].reshape(-1))
        idx = GroupIndex(plan=ours)
        np.testing.assert_array_equal(
            idx.read_tensor(n, buffer_reader(shards.reshape(-1), m)),
            arrays[n])


def test_extent_scaling_and_outer_guard():
    e = Extent(shard=2, lo=64, hi=160, tensor_lo=128)
    assert dataclasses.astuple(e.scaled(32)) == (2, 2, 5, 4)
    with pytest.raises(ValueError, match="not aligned"):
        Extent(0, 10, 20, 0).scaled(32)
    spec = TensorSpec("w", (8, 64), granularity=64)
    p1 = planner.plan_group([spec], 2, g_coll=128, align=64)
    a = GroupIndex(plan=p1)
    b = GroupIndex(plan=p1, outer_size=2, outer_dims={"w": 0})
    src = np.zeros(a.num_rows * p1.shard_size, np.float32)
    dst = np.zeros(b.num_rows * p1.shard_size, np.float32)
    with pytest.raises(ValueError, match="outer layout changed"):
        copy_tensor(a, b, "w", buffer_reader(src, a.num_rows),
                    buffer_reader(dst, b.num_rows), div=64)


@pytest.mark.parametrize("div", [1, 32])
def test_copy_tensor_matches_reference(div):
    """ragged (m = 2) -> fsdp2 / naive (m = 4) on random buffers: the
    destination buffers equal the reference's (block units at div 32 on
    the aligned path)."""
    rng = np.random.default_rng(div)
    src_t, src_j = _plan(planner, "ragged", 2), _plan(jax_planner, "ragged", 2)
    data = rng.normal(size=src_t.total // div).astype(np.float32)
    for name in ("fsdp2", "naive") if div == 1 else ("ragged",):
        m = 4
        dst_t, dst_j = _plan(planner, name, m), _plan(jax_planner, name, m)
        outs = []
        for pkg, s, d in ((None, src_t, dst_t), (jax_reshard, src_j, dst_j)):
            gi = GroupIndex if pkg is None else pkg.GroupIndex
            cp = copy_tensor if pkg is None else pkg.copy_tensor
            si, di = gi(plan=s), gi(plan=d)
            out = np.zeros(d.total // div, np.float32)
            for n, _, _ in SPECS:
                if div > 1 and n in ("b", "d"):
                    continue
                cp(si, di, n, buffer_reader(data, si.num_rows),
                   buffer_reader(out, di.num_rows), div=div,
                   aligned=div > 1)
            outs.append(out)
        np.testing.assert_array_equal(outs[0], outs[1])


# --------------------------------------------------------------------------- #
# the offline tool
# --------------------------------------------------------------------------- #

def _trained(tmp_path, over=None, sched=None, steps=2):
    """A one-rank port checkpoint of gemma2-2b.reduced() after ``steps``
    AdamW steps; returns (runtime, params, opt_state, path)."""
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              **(over or {}))
    rt = FSDPRuntime(build_model(cfg), init_local_group("gloo"),
                     device="cpu", compute_dtype=torch.float32,
                     schedule=CommSchedule(**sched) if sched else None)
    opt = make_optimizer(cfg)
    params, state = rt.init_params(0), opt.init(rt)
    fn = rt.make_train_step(opt)
    stream = SyntheticStream(DataConfig(cfg.vocab, SEQ, BATCH), cfg)
    for i in range(steps):
        params, state, _, _ = fn(params, state, i,
                                 stream.shard(stream.batch(i), rt))
    path = tmp_path / "src"
    ckpt.save(path, rt, params, state, step=steps)
    return rt, opt, params, state, path


def _same_dirs(a: Path, b: Path):
    names = sorted(p.name for p in (a / "shards").iterdir())
    assert names == sorted(p.name for p in (b / "shards").iterdir())
    for f in names:
        assert (a / "shards" / f).read_bytes() == \
            (b / "shards" / f).read_bytes(), f
    for f in ("meta.json", "plan.json"):
        assert json.loads((a / f).read_text()) == \
            json.loads((b / f).read_text()), f


def test_tool_identity_is_a_bitwise_copy(tmp_path):
    rt, _, _, _, src = _trained(tmp_path, steps=1)
    summary = tool.reshard(src, tmp_path / "dst", rt.plan, verbose=False,
                           device="cpu")
    assert sorted(summary["copied"]) == sorted(rt.layouts)
    assert not summary["streamed"]
    for f in sorted((src / "shards").glob("p__*.npy")):
        assert (tmp_path / "dst" / "shards" / f.name).read_bytes() == \
            f.read_bytes()
    # optimizer files are renumbered in the plan's group order (as the
    # reference tool numbers them): match them by their manifest paths
    metas = [json.loads((d / "meta.json").read_text())
             for d in (src, tmp_path / "dst")]
    files = [{tuple(e["path"]): e["file"] for e in m["opt"]} for m in metas]
    assert files[0].keys() == files[1].keys()
    for path, f in files[0].items():
        assert (src / "shards" / f"{f}__0.npy").read_bytes() == (
            tmp_path / "dst" / "shards" / f"{files[1][path]}__0.npy"
        ).read_bytes()


def _files_by_path(ckpt_dir):
    """A checkpoint's shard files keyed by what they hold: a parameter
    file by its name, an optimizer file by its leaf path and row (the
    tool numbers optimizer files in its plan's group order, a save in
    the sorted key order)."""
    meta = json.loads((ckpt_dir / "meta.json").read_text())
    shards = ckpt_dir / "shards"
    out = {f.name: f for f in shards.glob("p__*.npy")}
    for e in meta["opt"]:
        for f in shards.glob(e["file"] + "*.npy"):
            out["/".join(e["path"]) + f.name[len(e["file"]):]] = f
    return out


def _with_tp(cfg, tp: int):
    """``cfg`` tensor parallel of degree ``tp`` (as is for 1)."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, tp=tp))


def test_tool_matches_reference_tool(tmp_path, monkeypatch):
    """On the same checkpoint, the port's tool and the reference's write
    byte-identical files for ragged -> fsdp2, for 4 ranks under the
    bf16 store, for the q8_block store with its residual, for
    ``policies="auto"`` at 8 ranks (the port's launch.mesh constants set
    to the reference's) and for tp 2 on a (2, 2) mesh; the command line
    runs it too, across the model axis and back byte for byte."""
    import repro.launch.mesh as jax_mesh
    import repro_torch.launch.mesh as mesh

    for k in ("ICI_BW", "HBM_BW", "PEAK_FLOPS_BF16"):
        monkeypatch.setattr(mesh, k, getattr(jax_mesh, k))
    monkeypatch.syspath_prepend(str(REPO))
    from tools.reshard import reshard as jax_tool

    _, _, _, _, src = _trained(tmp_path)
    tc = get_config("gemma2-2b").reduced()
    jc = jax_get_config("gemma2-2b").reduced()
    cases = {"fsdp2": ({"data": 1, "model": 1}, None, "fsdp2"),
             "bf16x4": ({"data": 4, "model": 1}, {"param_store": "bf16"},
                        "ragged"),
             "q8": ({"data": 2, "model": 1}, Q8, "ragged"),
             "auto8": ({"data": 8, "model": 1}, "auto", "ragged"),
             # tensor parallelism: emb, head and the layers' q/k/v/w1/w2/wo
             # split over a model axis of 2
             "tp2": ({"data": 2, "model": 2}, None, "ragged")}
    for name, (axes, pol, pl) in cases.items():
        tpol = CommSchedule(**pol) if isinstance(pol, dict) else pol
        jpol = JaxSchedule(**pol) if isinstance(pol, dict) else pol
        tp = axes["model"]
        p_t = make_plan(build_model(_with_tp(tc, tp)), axes, tpol,
                        planner=pl)
        p_j = jax_policy.make_plan(jax_build_model(_with_tp(jc, tp)), axes,
                                   jpol, planner=pl)
        assert p_t.dumps() == p_j.dumps()
        s_t = tool.reshard(src, tmp_path / f"t_{name}", p_t, verbose=False,
                           device="cpu")
        s_j = jax_tool(src, tmp_path / f"j_{name}", p_j, verbose=False)
        assert s_t == s_j
        _same_dirs(tmp_path / f"t_{name}", tmp_path / f"j_{name}")
    tool.main([str(src), str(tmp_path / "cli"), "--data", "2",
               "--planner", "fsdp2", "--drop-opt", "--device", "cpu"])
    meta = json.loads((tmp_path / "cli" / "meta.json").read_text())
    assert meta["opt"] == [] and meta["groups"]["layers"]["mode"] == "fsdp2"
    # across the model axis: tp 2 on a model axis of 2 and back to tp 1
    # (the master and moment files byte for byte the source's)
    tool.main([str(src), str(tmp_path / "tp"), "--data", "1", "--model",
               "2", "--tp", "2", "--device", "cpu"])
    meta = json.loads((tmp_path / "tp" / "meta.json").read_text())
    assert meta["groups"]["layers"]["outer_size"] == 2
    tool.main([str(tmp_path / "tp"), str(tmp_path / "tp1"), "--tp", "1",
               "--device", "cpu"])
    files = _files_by_path(src)
    back = _files_by_path(tmp_path / "tp1")
    assert sorted(files) == sorted(back)
    for key, f in files.items():
        assert f.read_bytes() == back[key].read_bytes(), key


def test_adam8bit_state_reshards_through_the_tool(tmp_path):
    """8-bit Adam's int8 moment codes and block scales move 1 -> 4 ranks
    on the aligned extent path: tensor by tensor (in block units for the
    scales) the files hold what they held."""
    rt, _, _, _, src = _trained(tmp_path, {"optimizer": "adam8bit"})
    cfg = rt.cfg
    p4 = make_plan(build_model(cfg), {"data": 4, "model": 1})
    tool.reshard(src, tmp_path / "c4", p4, verbose=False, device="cpu")
    metas = [json.loads((d / "meta.json").read_text())
             for d in (src, tmp_path / "c4")]
    checked = 0
    for e_src in metas[0]["opt"]:
        e_dst = next(e for e in metas[1]["opt"] if e["path"] == e_src["path"])
        g, div = e_src["group"], e_src["div"]
        idx = [GroupIndex.from_meta(m["groups"][g]) for m in metas]
        reads = [ckpt.shard_file_reader(
            d / "shards", lambda j, f=e["file"]: ckpt.opt_shard_file(f, j))
            for d, e in ((src, e_src), (tmp_path / "c4", e_dst))]
        for name in idx[0].plan.names:
            for li in range(idx[0].n_layers) if idx[0].n_layers else [None]:
                a = idx[0]._read_part(name, 0, reads[0], li, div)
                b = idx[1]._read_part(name, 0, reads[1], li, div)
                np.testing.assert_array_equal(a, b)
                checked += 1
    assert checked > 40


_JAX_8DEV = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, numpy as np, jax, jax.numpy as jnp
    sys.path.insert(0, sys.argv[1])
    from repro.checkpoint import ckpt
    from repro.configs import build_model, get_config
    from repro.core.fsdp import FSDPRuntime
    from repro.data.pipeline import DataConfig, SyntheticStream
    from repro.launch.mesh import make_local_mesh
    from repro.optim import make_optimizer
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              learning_rate=float(sys.argv[4]))
    rt = FSDPRuntime(build_model(cfg), make_local_mesh(8, 1),
                     compute_dtype=jnp.float32)
    opt = make_optimizer(cfg)
    params, state = rt.init_params(0), opt.init(rt)
    fn = rt.make_train_step(opt)
    stream = SyntheticStream(DataConfig(cfg.vocab, int(sys.argv[5]),
                                        int(sys.argv[6])), cfg)
    st, losses = jnp.int32(0), []
    for i in range(3):
        if i == 2:
            ckpt.save(sys.argv[2], rt, params, state, step=2)
            snap = {k: np.asarray(v) for k, v in params.items()}
        params, state, st, m = fn(params, state, st,
                                  stream.shard(stream.batch(i), rt))
        losses.append(float(m["loss"]))
    np.savez(sys.argv[3], losses=np.asarray(losses), **snap)
""")


def _spawn_load(tmp_path, world, ckpt_dir, tag):
    ctx = multiprocessing.get_context("spawn")
    init_file, prefix = str(tmp_path / f"{tag}_store"), str(tmp_path / tag)
    procs = [ctx.Process(target=CW.rank_main,
                         args=(r, world, init_file, "load", str(ckpt_dir),
                               prefix, None, 1)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive and [p.exitcode for p in procs] == [0] * world
    return [dict(np.load(f"{prefix}{r}.npz")) for r in range(world)]


def test_reference_8_device_checkpoint_resumes_on_two_ranks(tmp_path):
    """The reference trains the quickstart config on 8 host devices and
    saves after two steps; ``python -m repro_torch.tools.reshard`` turns
    the checkpoint into a 2-rank one; 2 gloo ranks load it -- masters
    bitwise the reference's tensor by tensor -- and take step three.
    Measured: its loss within rtol 6.7e-8 of the reference's.  Asserted:
    1e-4 (tests/test_torch_train.py's bound)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run([sys.executable, "-c", _JAX_8DEV, str(REPO / "src"),
                    str(tmp_path / "c8"), str(tmp_path / "ref.npz"),
                    str(W.LR), str(W.SEQ), str(W.BATCH)],
                   check=True, env=env, timeout=300)
    ref = dict(np.load(tmp_path / "ref.npz"))
    assert json.loads((tmp_path / "c8" / "meta.json").read_text())[
        "groups"]["layers"]["num_shards"] == 8
    env["PYTHONPATH"] = str(REPO / "src")
    subprocess.run([sys.executable, "-m", "repro_torch.tools.reshard",
                    str(tmp_path / "c8"), str(tmp_path / "c2"), "--data",
                    "2", "--device", "cpu"], check=True, env=env,
                   timeout=300, capture_output=True)
    outs = _spawn_load(tmp_path, 2, tmp_path / "c2", "r")
    p2 = make_plan(build_model(W.quickstart_config()), {"data": 2,
                                                        "model": 1})
    jm = jax_build_model(dataclasses.replace(
        jax_get_config("gemma2-2b").reduced(), learning_rate=W.LR))
    p8 = jax_policy.make_plan(jm, {"data": 8, "model": 1})
    for name, e in p2.groups.items():
        got = np.concatenate([o[f"p/{name}"] for o in outs], axis=-1)
        want = ref[name]
        for li in range(e.n_layers) if e.n_layers else [None]:
            a = DBuffer(e.plan).unpack_np(got[li] if li is not None else got)
            b = JaxDBuffer(p8.groups[name].plan).unpack_np(
                want[li] if li is not None else want)
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), (name, k, li)
    np.testing.assert_allclose([o["losses"][0] for o in outs],
                               ref["losses"][2], rtol=1e-4)


# --------------------------------------------------------------------------- #
# replan
# --------------------------------------------------------------------------- #

def _leaves(params, state):
    out = {f"p/{n}/{k}": t.detach() for n, p in params.items()
           for k, t in (p.items() if isinstance(p, dict) else [("", p)])}
    out.update({f"o/{k}/{n}": t for k, v in state.items()
                for n, t in v.items()})
    return out


def test_replan_in_job_matches_a_checkpoint_round_trip(tmp_path):
    """On one rank, ``replan`` to the q8_block store with the q8 gradient
    wire and to the fsdp2 planner gives every parameter and optimizer leaf
    a save and a load into the new runtime give (masters bitwise, codes of
    ``ops.quantize``, the residual zero); a same-plan replan keeps the
    very tensors; training goes on; another world size raises."""
    rt, opt, params, state, path = _trained(tmp_path)
    for kw in ({"schedule": CommSchedule(**Q8)}, {"planner": "fsdp2"},
               {"policies": "auto"}):
        new_rt, p_new, s_new = rt.replan(params, state, optimizer=opt, **kw)
        via, _, s_via = ckpt.load(path, new_rt, make_optimizer(
            rt.cfg).init(new_rt))
        a, b = _leaves(p_new, s_new), _leaves(via, s_via)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (kw, k)
        if new_rt.layouts["layers"].store.quantized:
            for n, lo in new_rt.layouts.items():
                codes, _ = ops.quantize(p_new[n]["master"].detach(),
                                        lo.store.block)
                assert torch.equal(codes, p_new[n]["codes"])
                assert not p_new[n]["reduce_ef"].count_nonzero()
    same_rt, p_same, s_same = rt.replan(params, state, optimizer=opt)
    assert all(p_same[n] is params[n] for n in params)
    assert all(s_same[k][n] is state[k][n] for k in state for n in state[k])
    fn = new_rt.make_train_step(opt)
    stream = SyntheticStream(DataConfig(rt.cfg.vocab, SEQ, BATCH), rt.cfg)
    _, _, _, m = fn(p_new, s_new, 2, stream.shard(stream.batch(2), new_rt))
    assert np.isfinite(float(m["loss"]))
    # another mesh on the same ranks is a replan (tests/test_torch_tp_ckpt
    # .py); more ranks than the process group holds go through a save
    for mesh in ({"data": 1, "model": 2}, {"data": 2}):
        with pytest.raises(ValueError, match="checkpoint.save"):
            rt.replan(params, mesh=mesh)
