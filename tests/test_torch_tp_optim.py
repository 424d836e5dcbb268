"""Muon and Shampoo across the model and pod axes on 4 gloo ranks: 3 fp32
steps of a 4 x 32 batch (lr 1e-2) against the port's one-rank run of the
same optimizer --
  * tensor parallelism: gemma2-2b.reduced() (4 KV heads: the KV
    projections split) at tp 2 on data 2 x model 2 and at tp 4 on data 1 x
    model 4; nemotron-4-340b.reduced() at the reference's tp widths (2 KV
    heads: at tp 4 wk and wv in its ``layers_rep`` group) at tp 4, and
    Muon at tp 2 on the q8_block store;
  * HSDP: gemma2-2b.reduced() on pod 2 x data 2, with and without
    ``pod_fsdp``, against flat data 4;
  * expert parallelism: qwen3-moe-235b-a22b.reduced() with the batch over
    ``data`` at a capacity no expert overflows, at ep 2 on data 2 x model 2
    against FSDP over the same mesh without ep (each data rank's half of
    the batch carries its own load-balance term, so no one-rank run is
    the same function), and at ep 4 on data 1 x model 4 against one rank
    (the experts' 3-D tensors take the Adam fallback; nothing is
    assembled);
  * a tp-2 Shampoo checkpoint, rewritten by ``tools.reshard --tp 1`` and
    resumed on one rank, against the uninterrupted one-rank run;
and two departures of the reference (a JAX subprocess with 4 host
devices, ``check_vma=False`` as it runs): under tp its Muon and Shampoo
precondition each model rank's part of a matrix, and its Shampoo factors,
declared replicated over the model axis, differ between model ranks.

Parity classes (bounds with the measured readings beside them):
  * Muon under tp against one rank: the port assembles each split matrix
    whole before Newton-Schulz, so the update is the one-device update up
    to fp32 sums split over ranks, which Newton-Schulz amplifies (the TP
    class of tests/test_torch_tp.py): losses within 1e-6, grad norms 1e-5
    relative, masters 2e-5 relative L2 (measured 1.4e-7, 2.9e-6, 8.7e-7);
  * Shampoo under tp: the same plus ``eigh``'s class on the factors
    (ROADMAP Queue 3: up to 7.6e-4 on ill-conditioned factors): losses
    1e-6, grad norms 1e-5, masters 1e-4 (measured 1.3e-7, 2.9e-6,
    8.7e-7);
  * HSDP against flat data 4: ``pod_fsdp`` BITWISE (the same 4-rank
    group); without it ALLCLOSE, the classes above (measured 1.4e-7,
    4.9e-7, 2.3e-7);
  * ep against its counterpart: ALLCLOSE as tests/test_torch_ep.py (1e-6,
    1e-5, 2e-5; measured 6.0e-8, 3.3e-7, 9.2e-8);
  * Muon on the q8_block store: its codes flip under the rounding above
    (the class of tests/test_torch_train_optim.py, 7.06e-6 / 3.46e-5):
    masters 1e-4 (measured 4.3e-6);
  * the resumed step: Shampoo's class against the uninterrupted run.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mesh_worker as MW
from repro_torch.launch.mesh import init_local_group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, NEMO, MOE = "gemma2-2b", "nemotron-4-340b", "qwen3-moe-235b-a22b"
DATA = dict(fsdp_axes=("data",), batch_axes=("data",))
DM = ("data", "model")
POD_FSDP = {**DATA, "pod_fsdp": True}
MUON, SHAMPOO = {"optimizer": "muon"}, {"optimizer": "shampoo"}
Q8 = {"param_store": "q8_block"}
# capacity factor 4: no expert overflows at any split of the batch, so the
# MoE layer is the same function of the batch on any mesh
MOE_MUON = {**MUON, "capacity_factor": 4.0}


def _tp(tp):
    return {**DATA, "tp": tp}


# name: (data or [pod, data], model, arch, parallel, fields, schedule)
RUNS = {"muon_tp2": (2, 2, G, _tp(2), MUON, None),
        "shampoo_tp2": (2, 2, G, _tp(2), SHAMPOO, None),
        "muon_tp4": (1, 4, G, _tp(4), MUON, None),
        "shampoo_tp4": (1, 4, G, _tp(4), SHAMPOO, None),
        "nemo_muon_tp4": (1, 4, NEMO, _tp(4), MUON, None),
        "nemo_shampoo_tp4": (1, 4, NEMO, _tp(4), SHAMPOO, None),
        "nemo_muon_tp2_q8": (2, 2, NEMO, _tp(2), MUON, Q8),
        "muon_flat4": (4, 1, G, DATA, MUON, None),
        "muon_hsdp": ([2, 2], 1, G, DATA, MUON, None),
        "muon_pod_fsdp": ([2, 2], 1, G, POD_FSDP, MUON, None),
        "shampoo_flat4": (4, 1, G, DATA, SHAMPOO, None),
        "shampoo_hsdp": ([2, 2], 1, G, DATA, SHAMPOO, None),
        "shampoo_pod_fsdp": ([2, 2], 1, G, POD_FSDP, SHAMPOO, None),
        "muon_ep2": (2, 2, MOE, dict(fsdp_axes=DM, batch_axes=("data",),
                                     ep=2), MOE_MUON, None),
        "muon_moe_dm": (2, 2, MOE, dict(fsdp_axes=DM, batch_axes=("data",)),
                        MOE_MUON, None),
        "muon_ep4": (1, 4, MOE, dict(fsdp_axes=DM, batch_axes=("data",),
                                     ep=4), MOE_MUON, None)}
# each run and the run it is held to: a one-rank run (name in ONE) or
# another 4-rank run; True: bitwise
AGAINST = {"muon_tp2": ("g_muon", False), "shampoo_tp2": ("g_shampoo", False),
           "muon_tp4": ("g_muon", False), "shampoo_tp4": ("g_shampoo", False),
           "nemo_muon_tp4": ("nemo_muon", False),
           "nemo_shampoo_tp4": ("nemo_shampoo", False),
           "nemo_muon_tp2_q8": ("nemo_muon_q8", False),
           "muon_hsdp": ("muon_flat4", False),
           "muon_pod_fsdp": ("muon_flat4", True),
           "shampoo_hsdp": ("shampoo_flat4", False),
           "shampoo_pod_fsdp": ("shampoo_flat4", True),
           "muon_ep2": ("muon_moe_dm", False),
           "muon_ep4": ("moe_muon", False)}
# the one-rank runs: (arch, fields, schedule, steps)
ONE = {"g_muon": (G, MUON, None, 3), "g_shampoo": (G, SHAMPOO, None, 3),
       "g_shampoo4": (G, SHAMPOO, None, 4),
       "nemo_muon": (NEMO, MUON, None, 3),
       "nemo_shampoo": (NEMO, SHAMPOO, None, 3),
       "nemo_muon_q8": (NEMO, MUON, Q8, 3), "moe_muon": (MOE, MOE_MUON, None, 3)}
# (loss rtol, grad-norm rtol, master rel-L2) per class
BOUND = {"muon": (1e-6, 1e-5, 2e-5), "shampoo": (1e-6, 1e-5, 1e-4),
         "q8": (1e-6, 1e-5, 1e-4)}

# The reference's Muon and Shampoo under tp, in a JAX subprocess with 4
# host devices: nemotron-4-340b.reduced() at the tp widths, one step at tp
# 1 (data 1) and tp 2 (data 2 x model 2).  Writes ``<run>/p/<tensor>``, the
# first step's preconditioned direction of each 2-D tensor whole
# (recovered in float64 from w' = w - lr (p + wd w)), ``factor_gap/<key>``
# the largest difference between the two model ranks' shards of each
# Shampoo factor at tp 2 (declared replicated over ``model``), and the
# tp-2 Shampoo state saved under argv[3].
REF_SCRIPT = r'''
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[1])
from repro.checkpoint import ckpt
from repro.configs import build_model, get_config
from repro.configs.base import ParallelConfig
from repro.core.fsdp import FSDPRuntime
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer
out_path, ckpt_dir = sys.argv[2], sys.argv[3]
LR, WD = 1e-2, 0.1

def tensors(rt, params):
    out = {}
    for g, lo in rt.layouts.items():
        st = params[g]
        glob = np.asarray(st["master"] if isinstance(st, dict) else st,
                          np.float64)
        rows = glob.reshape(glob.shape[:-1] + (lo.outer_size, lo.plan.total))
        for s in lo.gdef.specs:
            if len(s.shape) != 2 or lo.n_layers is None:
                continue
            per = []
            for li in range(lo.n_layers):
                got = [lo.buffer.unpack_np(rows[li][r])[s.name]
                       for r in range(lo.outer_size)]
                sd = lo.gdef.outer.get(s.name)
                per.append(got[0] if sd is None or lo.outer_size == 1
                           else np.concatenate(got, axis=sd.dim))
            out[s.name] = np.stack(per)
    return out

out = {}
for name, opt, tp, data, model in (("muon_tp1", "muon", 1, 1, 1),
                                   ("muon_tp2", "muon", 2, 2, 2),
                                   ("shampoo_tp1", "shampoo", 1, 1, 1),
                                   ("shampoo_tp2", "shampoo", 2, 2, 2)):
    cfg = dataclasses.replace(
        get_config("nemotron-4-340b").reduced(), learning_rate=LR,
        n_heads=4, n_kv_heads=2, head_dim=64, d_model=256, d_ff=512,
        optimizer=opt, parallel=ParallelConfig(
            fsdp_axes=("data",), batch_axes=("data",), tp=tp))
    mesh = make_local_mesh(data, model)
    rt = FSDPRuntime(build_model(cfg), mesh, compute_dtype=jnp.float32,
                     donate=False)
    o = make_optimizer(cfg)
    params, state = rt.init_params(0), o.init(rt)
    w0 = tensors(rt, params)
    stream = SyntheticStream(DataConfig(cfg.vocab, 32, 4), cfg)
    params, state, _, _ = rt.make_train_step(o)(
        params, state, jnp.int32(0), stream.shard(stream.batch(0), rt))
    lr0 = LR * 0.01          # the warmup's first step
    for k, w1 in tensors(rt, params).items():
        out[f"{name}/p/{k}"] = -(w1 - w0[k]) / lr0 - WD * w0[k]
    if name == "shampoo_tp2":
        devs = mesh.devices
        for key, f in state["factors"].items():
            by = {}
            for sh in f.addressable_shards:
                d, m = [int(i[0]) for i in np.nonzero(devs == sh.device)]
                by[d, m] = np.asarray(sh.data)
            out["factor_gap/" + key] = np.asarray(max(
                float(np.abs(by[d, 0] - by[d, 1]).max()) for d in range(data)))
            out["factor_shape/" + key] = np.asarray(f.shape)
        ckpt.save(ckpt_dir, rt, params, state, step=1)
np.savez(out_path, **out)
'''


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """The 4-rank runs (the tp-2 Shampoo run saved), the one-rank runs in
    process and the reference's readings, all started at once."""
    tmp = tmp_path_factory.mktemp("tp_optim")
    ref_out, ref_ckpt = str(tmp / "ref.npz"), str(tmp / "ref_ckpt")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["OPENBLAS_NUM_THREADS"] = "1"  # as _torch_train_worker.one_blas_thread
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                            os.path.join(ROOT, "src"), ref_out, ref_ckpt],
                           env=env)
    saved = str(tmp / "shampoo_tp2")
    procs = MW.spawn(4, tmp, RUNS, saves={"shampoo_tp2": saved})
    group = init_local_group("gloo")
    one = {name: MW.run(group, MW.config(arch, DATA, **fields),
                        schedule=sched, steps=steps)
           for name, (arch, fields, sched, steps) in ONE.items()}
    outs = MW.join(*procs)
    assert ref.wait(timeout=300) == 0
    return {"port": MW.runs_of(outs, RUNS), "one": one, "saved": saved,
            "ref": dict(np.load(ref_out)), "ref_ckpt": ref_ckpt,
            "tmp": tmp}


@pytest.mark.parametrize("name", list(AGAINST))
def test_muon_and_shampoo_across_ranks_match(name, streams):
    """Each run's loss and grad-norm streams and final masters against the
    run it is held to (the classes above)."""
    other, exact = AGAINST[name]
    got = streams["port"][name]
    want = streams["one"].get(other) or streams["port"][other]
    keys = [k for k in want if k != "metrics" and not k.startswith("ef")]
    assert len(keys) > 5
    if exact:
        assert np.array_equal(got["metrics"], want["metrics"])
        for k in keys:
            assert np.array_equal(got[k].view(np.int32),
                                  want[k].view(np.int32)), k
        return
    cls = ("q8" if name.endswith("q8") else
           "shampoo" if "shampoo" in name else "muon")
    loss, gnorm, master = BOUND[cls]
    steps = got["metrics"].shape[0]
    np.testing.assert_allclose(got["metrics"][:, 0],
                               want["metrics"][:steps, 0], rtol=loss)
    np.testing.assert_allclose(got["metrics"][:, 1],
                               want["metrics"][:steps, 1], rtol=gnorm)
    for k in keys:
        assert got[k].shape == want[k].shape, k
        err = MW.rel_l2(got[k], want[k])
        assert err < master, (name, k, err)
    assert got["metrics"][-1, 0] != got["metrics"][0, 0]


def test_tp_shampoo_checkpoint_resumes_at_tp1(streams):
    """The tp-2 Shampoo run's checkpoint holds the whole matrices'
    factors; ``tools.reshard --tp 1`` copies those files unchanged, and
    the resumed one-rank run's next step matches the uninterrupted
    one-rank run's fourth step (Shampoo's class)."""
    import json
    import pathlib

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import build_model
    from repro_torch.core.fsdp import FSDPRuntime
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.optim import make_optimizer
    from repro_torch.tools import reshard as tool

    src = pathlib.Path(streams["saved"])
    dst = streams["tmp"] / "tp1"
    tool.main([str(src), str(dst), "--arch", G, "--optimizer", "shampoo",
               "--tp", "1", "--device", "cpu"])
    def factor_files(d):
        man = json.loads((d / "meta.json").read_text())["opt"]
        return {"/".join(e["path"]): d / "shards" / f"{e['file']}.npy"
                for e in man if e["kind"] == "factor"}

    src_facs, facs = factor_files(src), factor_files(dst)
    assert sorted(facs) == sorted(src_facs) and len(facs) > 4
    for k, f in facs.items():
        assert f.read_bytes() == src_facs[k].read_bytes(), k
    cfg = MW.config(G, DATA, **SHAMPOO)
    rt = FSDPRuntime(build_model(cfg), init_local_group("gloo"),
                     device="cpu", compute_dtype=torch.float32)
    opt = make_optimizer(cfg)
    params, step, state = ckpt.load(dst, rt, opt.init(rt))
    assert step == 3
    for k, (L, a, _) in ((k, v.shape) for k, v in state["factors"].items()):
        assert L == 2 and a in (256, 512, 1024), (k, a)
    stream = SyntheticStream(DataConfig(cfg.vocab, 32, 4), cfg)
    _, _, _, m = rt.make_train_step(opt)(params, state, step,
                                         stream.shard(stream.batch(3), rt))
    want = streams["one"]["g_shampoo4"]["metrics"][3]
    loss, gnorm, _ = BOUND["shampoo"]
    assert float(m["loss"]) == pytest.approx(want[0], rel=loss)
    assert float(m["grad_norm"]) == pytest.approx(want[1], rel=gnorm)


def test_reference_tp_factors_of_a_part_are_refused(streams):
    """The reference's tp-2 Shampoo checkpoint holds the factors of each
    rank's part of a matrix (``(L, b / 2, b / 2)`` for a column-split
    one); the port's one-rank load refuses them with its factor shape
    error rather than read another matrix's factors."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import build_model
    from repro_torch.core.fsdp import FSDPRuntime
    from repro_torch.optim import make_optimizer

    cfg = MW.config(NEMO, DATA, **SHAMPOO)
    rt = FSDPRuntime(build_model(cfg), init_local_group("gloo"),
                     device="cpu", compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="saved factor shape"):
        ckpt.load(streams["ref_ckpt"], rt, make_optimizer(cfg).init(rt))


def test_reference_tp_preconditions_parts(streams):
    """The reference's departure under tp (ROADMAP Queue 3): its first
    step's Muon direction of each split matrix at tp 2 is that of the
    matrix's parts, far outside the Newton-Schulz class of the tp-1
    direction (measured relative L2 0.40-1.32 over wq, wo, w1 and w2; the
    class 2e-5); its Shampoo direction is the parts' too (0.34-0.65 once
    rescaled), and tp times the tp-1 direction's norm (the gradient factor
    of Queue 3 survives the RMS graft: measured ratio 1.99999 per
    tensor)."""
    ref = streams["ref"]
    for k in ("wq", "wo", "w1", "w2"):
        p1, p2 = ref[f"muon_tp1/p/{k}"], ref[f"muon_tp2/p/{k}"]
        assert MW.rel_l2(p2, p1) > 0.05, (k, MW.rel_l2(p2, p1))
        s1, s2 = ref[f"shampoo_tp1/p/{k}"], ref[f"shampoo_tp2/p/{k}"]
        ratio = np.linalg.norm(s2) / np.linalg.norm(s1)
        assert ratio == pytest.approx(2.0, rel=0.02), (k, ratio)
        assert MW.rel_l2(s2 / ratio, s1) > 0.05, k


def test_reference_tp_factors_differ_between_model_ranks(streams):
    """The reference declares Shampoo's factors replicated over the model
    axis (``P(fsdp_axes, None, None)``), yet each model rank accumulates
    the factors of its own part: the two model ranks' shards of a split
    matrix's factor differ (a checkpoint or a gather reads model rank 0's;
    measured largest gaps 0.086-2.30 over the 12 factors of the split wq,
    wk, wv, wo, w1 and w2), and its global shape is the part's."""
    ref = streams["ref"]
    gaps = {k.split("/", 1)[1]: float(v) for k, v in ref.items()
            if k.startswith("factor_gap/")}
    assert len(gaps) == 12      # wq, wk, wv, wo, w1, w2: L and R
    for k, gap in gaps.items():
        assert gap > 0, k
    assert tuple(ref["factor_shape/layers/w1/R"]) == (2, 256, 256)


def test_redistribution_cost_at_published_width():
    """``launch.redistribution`` at nemotron-4-340b's published width on
    {data 16, model 16} (its tp 16): per rank and step the three fp32
    all-gathers of the ``layers`` group each receive 15/16 of the 6 layers
    x 4 split matrices' parts it handles x 16 (76.4 GB each), and each
    rank runs Newton-Schulz on its 6 layers' whole wq, wo, w1 and w2 --
    the same 24 matrices on all 16 ranks of the model axis."""
    from repro_torch.configs import get_config
    from repro_torch.launch.redistribution import redistribution

    cfg = dataclasses.replace(get_config(NEMO), optimizer="muon")
    got = redistribution(cfg, {"data": 16, "model": 16})
    layers = got["layers"]
    assert layers["matrices"] == 6 * 4
    parts = 2 * 18432 * 18432 // 16 + 2 * 18432 * 73728 // 16
    want = 15 * 6 * parts * 4
    assert layers["cols"] == layers["model"] == layers["rows"] == want
    assert got["layers_rep"]["model"] == 0
    w1 = 5 * (4 * 18432 ** 2 * 73728 + 2 * 18432 ** 3)
    wq = 5 * 6 * 18432 ** 3
    assert layers["ns_flop"] == 6 * 2 * (w1 + wq)
