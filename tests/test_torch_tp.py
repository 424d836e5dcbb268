"""Tensor parallelism with and without sequence parallelism on gloo meshes:
nemotron-4-340b.reduced() at the reference's tp-scenario widths (4 heads,
2 KV heads, head_dim 64, d_model 256, d_ff 512), AdamW, 3 fp32 steps of a
4 x 32 batch, on data 1 x model 2 (KV heads split), data 1 x model 4 (KV
replicated: the ``layers_rep`` group and each rank's KV-head slice) and
data 2 x model 2 -- against the port's one-rank run and against the
reference on as many host devices (a JAX subprocess with 4).  Also SGD at
tp 2, nemotron's own recipe (SP, 2 microbatches, 8-bit Adam) at tp 2, the
vocab-parallel embedding and cross entropies against their tp = 1 forms,
``init_params`` / ``load_reference_state`` on outer-split groups, a
checkpoint round trip and the serve steps on the model axis, the reshard
tool onto it against the reference's, and nemotron's config and
published-width plans.

Parity classes (bounds with the measured readings beside them):
  * against the port's one-rank run: ALLCLOSE, fp32 rounding of sums split
    over ranks (losses within 1e-6, grad norms within 1e-5 relative;
    masters: AdamW's first steps divide tiny gradients by their own root
    mean square, so an element's step moves with its rounding);
  * against the reference: its gradient is tp times the one-device
    gradient (its ``psum`` transposes to ``psum`` under shard_map, and
    ``final_ln``'s copies take partial gradients), which AdamW hides but
    for eps and for those copies: losses ALLCLOSE, the port's grad norm
    the reference's divided by tp within the copies' share;
  * ``init_params`` and ``load_reference_state``: BITWISE.
"""
import os

import numpy as np
import pytest
import torch

import _torch_mesh_worker as MW
from repro_torch.launch.mesh import init_local_group
from repro_torch.models import layers as L

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEMO = "nemotron-4-340b"
DATA = ("data",)


def _par(tp=1, sp=False):
    return dict(fsdp_axes=DATA, batch_axes=DATA, tp=tp,
                sequence_parallel=sp)


# name: (data, model, arch, parallel, fields, schedule)
RUNS2 = {"tp2": (1, 2, NEMO, _par(2), {}, None),
         "tp2_sp": (1, 2, NEMO, _par(2, True), {}, None),
         "tp2_sgd": (1, 2, NEMO, _par(2), {"optimizer": "sgd"}, None),
         # nemotron's own recipe: SP, microbatches and 8-bit Adam
         "tp2_sp_micro_adam8": (1, 2, NEMO, {**_par(2, True),
                                             "microbatches": 2},
                                {"optimizer": "adam8bit"}, None)}
RUNS4 = {"tp4": (1, 4, NEMO, _par(4), {}, None),
         "tp4_sp": (1, 4, NEMO, _par(4, True), {}, None),
         "tp2_data2_sp": (2, 2, NEMO, _par(2, True), {}, None)}
REF_RUNS = {"one": (1, 1, NEMO, _par(), {}, None),
            **{k: v for k, v in {**RUNS2, **RUNS4}.items()
               if k != "tp2_sgd"}}
TP_OF = {"tp2": 2, "tp2_sp": 2, "tp2_sgd": 2, "tp2_sp_micro_adam8": 2,
         "tp4": 4, "tp4_sp": 4, "tp2_data2_sp": 2}
# the one-rank run each is held against: its optimizer, one microbatch
ONE_OF = {"tp2_sgd": "sgd", "tp2_sp_micro_adam8": "adam8bit"}


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """The port's runs (2 and 4 gloo ranks, one rank in process) and the
    reference's, all started at once."""
    tmp = tmp_path_factory.mktemp("tp")
    ref_out = str(tmp / "ref.npz")
    ref = MW.start_reference(os.path.join(ROOT, "src"), ref_out, REF_RUNS,
                             init=["tp2"])
    p2 = MW.spawn(2, tmp, RUNS2, init=["tp2"], ref_init=ref_out + ".init",
                functions=True)
    p4 = MW.spawn(4, tmp, RUNS4)
    group = init_local_group("gloo")
    one = {opt: MW.run(group, MW.config(NEMO, _par(), optimizer=opt))
           for opt in ("adamw", "sgd", "adam8bit")}
    one["serve"] = MW.serve_logits(group, MW.serve_config(1, 1))
    o2, o4 = MW.join(*p2), MW.join(*p4)
    assert ref.wait(timeout=300) == 0
    port = {**MW.runs_of(o2, RUNS2), **MW.runs_of(o4, RUNS4)}
    data = dict(np.load(ref_out))
    ref_runs = {n: {k.split("/", 1)[1]: v for k, v in data.items()
                    if k.startswith(n + "/")} for n in REF_RUNS}
    return {"port": port, "one": one, "ref": ref_runs, "ranks2": o2,
            "ref_init": dict(np.load(ref_out + ".init"))}


@pytest.mark.parametrize("name", list(TP_OF))
def test_tp_matches_one_rank(name, streams):
    """Measured (loss, grad norm, worst master rel-L2): tp2 and tp2_sp
    1.2e-7, 3.2e-7, 4.0e-6; tp2_sgd 1.2e-7, 2.0e-7, 6.3e-9;
    tp2_sp_micro_adam8 4.8e-7, 3.2e-7, 2.3e-5 (8-bit moments: a rounding
    can move a code); tp4 0, 1.1e-7, 2.1e-6; tp4_sp 1.2e-7, 2.1e-7,
    2.4e-6; tp2_data2_sp 1.2e-7, 3.2e-7, 4.2e-6."""
    got = streams["port"][name]
    want = streams["one"][ONE_OF.get(name, "adamw")]
    np.testing.assert_allclose(got["metrics"][:, 0], want["metrics"][:, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(got["metrics"][:, 1], want["metrics"][:, 1],
                               rtol=1e-5)
    for k, v in want.items():
        if k != "metrics":
            assert got[k].shape == v.shape, k
            bound = 1e-4 if name.endswith("adam8") else 2e-5
            assert MW.rel_l2(got[k], v) < bound, (k, MW.rel_l2(got[k], v))


@pytest.mark.parametrize("name", list(REF_RUNS)[1:])
def test_tp_matches_reference(name, streams):
    """The reference's tp run: the same losses, and a grad norm tp times
    the port's (its gradient factor; ROADMAP Queue 3).  Measured over the
    six runs: losses within 6.8e-6, norm x tp within 3.3e-5 (the
    reference's ``final_ln`` copies, each with a partial gradient)."""
    got, ref = streams["port"][name], streams["ref"][name]
    tp = TP_OF[name]
    np.testing.assert_allclose(got["metrics"][:, 0], ref["metrics"][:, 0],
                               rtol=3e-5)
    # the reference's final_ln copies have drifted apart (the port's are
    # bitwise one another: ``full_tensors`` asserts it)
    assert float(ref["copy_gap/final_ln"]) > 0
    np.testing.assert_allclose(got["metrics"][:, 1] * tp,
                               ref["metrics"][:, 1], rtol=1.5e-4)


def test_reference_tp_gradient_factor(streams):
    """The fault of the reference recorded in ROADMAP Queue 3: at the first
    step (same weights, same loss) its grad norm under tp is tp times its
    one-device norm (measured 1.99998 at tp 2, 3.99993 at tp 4: the
    ``final_ln`` copies' partial gradients make up the rest); the port's
    equals its one-rank norm."""
    one = streams["ref"]["one"]["metrics"][0]
    for name in ("tp2", "tp4", "tp4_sp"):
        ref = streams["ref"][name]["metrics"][0]
        assert ref[0] == pytest.approx(one[0], rel=1e-6)
        assert ref[1] / one[1] == pytest.approx(TP_OF[name], rel=1e-4)
        port = streams["port"][name]["metrics"][0]
        assert port[1] == pytest.approx(
            streams["one"]["adamw"]["metrics"][0][1], rel=1e-6)


def test_vocab_parallel_functions_match_tp1(streams):
    """``embed`` + ``reduce_out``, ``vocab_parallel_ce`` and TP
    ``chunked_ce`` on 2 ranks, each with half of the vocab, against the
    tp = 1 functions on the whole: values and the input's gradient on every
    rank, each rank's head and table gradient its columns / rows of the
    whole one."""
    inp = MW.function_inputs()
    V = inp["head"].shape[1]
    labels = torch.from_numpy(inp["labels"])
    mask = torch.ones(labels.shape)
    want = {}
    for kind in ("vocab_parallel_ce", "chunked_ce"):
        x = torch.from_numpy(inp["x"]).requires_grad_()
        head = torch.from_numpy(inp["head"]).requires_grad_()
        if kind == "chunked_ce":
            nll, _ = L.chunked_ce(x, head, labels, mask, vocab_chunk=16,
                                  softcap=30.0)
        else:
            nll, _ = L.vocab_parallel_ce(L.lm_logits(x, head, softcap=30.0),
                                         labels, mask)
        nll.backward()
        want[kind] = (nll.item(), x.grad.numpy(), head.grad.numpy())
    emb = torch.from_numpy(inp["emb"]).requires_grad_()
    e = L.embed(torch.from_numpy(inp["tokens"]), emb)
    (e * torch.from_numpy(inp["w"])).sum().backward()
    for r, o in enumerate(streams["ranks2"]):
        cols = slice(r * V // 2, (r + 1) * V // 2)
        for kind, (loss, dx, dhead) in want.items():
            assert float(o[f"fn/{kind}/loss"]) == pytest.approx(loss,
                                                                rel=1e-6)
            np.testing.assert_allclose(o[f"fn/{kind}/dx"], dx, rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(o[f"fn/{kind}/dhead"],
                                       dhead[:, cols], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(o["fn/embed/out"], e.detach().numpy())
        np.testing.assert_array_equal(o["fn/embed/demb"],
                                      emb.grad.numpy()[cols])


def test_init_and_load_reference_state_bitwise(streams):
    """tp 2 on data 1 x model 2: each rank's ``init_params`` is its column
    block of the reference's global buffer (its outer row: emb rows, head
    columns, q/k/v/w1 columns and wo/w2 rows of its TP part), and
    ``load_reference_state`` of the reference's state gives it back."""
    ref = streams["ref_init"]
    groups = sorted({k.split("/")[2] for k in ref})
    assert groups == ["globals", "layers", "layers_rep"]
    for r, o in enumerate(streams["ranks2"]):
        for g in groups:
            glob = ref[f"init/tp2/{g}/master"]
            # layers/globals are split over the model axis (rank r's outer
            # row); layers_rep is whole on every rank of it
            blocks = 1 if g == "layers_rep" else 2
            i = r if blocks == 2 else 0
            n = glob.shape[-1] // blocks
            want = glob[..., i * n:(i + 1) * n]
            got = o[f"init/tp2/{g}"]
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), g
            assert np.array_equal(o[f"load/tp2/{g}/master"].view(np.int32),
                                  want.view(np.int32)), g


def test_q8_reduce_wire_on_layers_rep_raises(streams):
    """The reference's ValueError: a q8 reduce wire on a group whose
    gradient is all-reduced over the model axis after its reduce-scatter
    (``layers_rep`` under tp) would keep one residual per replica.  Muon
    and Shampoo initialise on the same outer-split groups without an
    error (their runs across the model axis are held in
    tests/test_torch_tp_optim.py)."""
    for o in streams["ranks2"]:
        msg = str(o["err/q8_layers_rep"])
        assert "replica gradient axes ['model']" in msg, msg
        for opt in ("muon", "shampoo"):
            assert str(o[f"err/{opt}"]) == "", opt


@pytest.mark.parametrize("what", ["save", "load", "prefill", "decode"])
def test_checkpoint_and_serving_on_a_model_axis(what, streams):
    """On a data 1 x model 2 mesh at tp 2: ``ckpt.save`` writes each block
    once -- rows ``r * m + k`` of the split groups (0 and 1 here), one row
    of ``layers_rep`` -- and ``ckpt.load`` reads the master and the
    moments back bitwise; the prefill and decode steps (gemma2-2b.reduced()
    with one KV head) return the whole (B, 1, V) logits, the same bits on
    both ranks, within 1e-4 relative L2 of the one-rank serve (the bound
    of tests/test_torch_tp_serve.py; measured 4.0e-6-1.4e-5)."""
    ranks = streams["ranks2"]
    if what == "save":
        files = set(str(f) for f in ranks[0]["ck/files"])
        for g, rows in (("layers", 2), ("globals", 2), ("layers_rep", 1)):
            got = {f for f in files if f.startswith(f"p__{g}__master__")}
            assert got == {f"p__{g}__master__{j}.npy" for j in range(rows)}
        return
    if what == "load":
        for o in ranks:
            assert int(o["ck/step"]) == 3
            assert bool(o["ck/master_equal"]) and bool(o["ck/moments_equal"])
        return
    calls = [0] if what == "prefill" else [1, 2]
    want = streams["one"]["serve"]
    for o in ranks:
        got = o["serve/fn"]
        assert got.shape == want.shape
        assert np.array_equal(got.view(np.int32),
                              ranks[0]["serve/fn"].view(np.int32))
        for c in calls:
            assert MW.rel_l2(got[c], want[c]) < 1e-4, (c, MW.rel_l2(
                got[c], want[c]))


@pytest.mark.parametrize("argv", [["--model", "2"],
                                  ["--data", "2", "--model", "2", "--tp",
                                   "2"],
                                  ["--arch", NEMO, "--full"]])
def test_reshard_tool_across_a_model_axis(argv, tmp_path, monkeypatch):
    """``python -m repro_torch.tools.reshard`` onto a model axis writes the
    files the reference's ``tools/reshard.py`` writes, byte for byte (a
    model axis the config does not use, and tp 2 on data 2 x model 2), and
    back at ``--tp 1`` the source's; nemotron-4-340b at published width
    (its own tp 16 on data 16 x model 16) plans as the reference's tool
    plans (plan only: no checkpoint of that size is written)."""
    import argparse
    import dataclasses

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import build_model, get_config
    from repro_torch.core.fsdp import FSDPRuntime
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.optim import make_optimizer
    from repro_torch.tools import reshard as tool

    monkeypatch.syspath_prepend(ROOT)
    from tools import reshard as jax_tool

    def args_of(pairs, reduced=True):
        ns = argparse.Namespace(arch="gemma2-2b", reduced=reduced,
                                optimizer=None, tp=0, data=1, model=1,
                                planner="ragged", policies=None, layers=0)
        for k, v in zip(pairs[::2], pairs[1::2]):
            k = k.lstrip("-")
            setattr(ns, k, int(v) if k in ("tp", "data", "model") else v)
        return ns

    if "--full" in argv:
        pairs = ["--arch", NEMO, "--data", "16", "--model", "16"]
        got = tool.build_new_plan(args_of(pairs, reduced=False))
        want = jax_tool.build_new_plan(args_of(pairs, reduced=False))
        assert got.dumps() == want.dumps()
        assert got.groups["layers"].outer_size == 16
        return
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              learning_rate=MW.LR)
    rt = FSDPRuntime(build_model(cfg), init_local_group("gloo"),
                     device="cpu", compute_dtype=torch.float32)
    opt = make_optimizer(cfg)
    stream = SyntheticStream(DataConfig(cfg.vocab, 32, 4), cfg)
    params, state, _, _ = rt.make_train_step(opt)(
        rt.init_params(0), opt.init(rt), 0,
        stream.shard(stream.batch(0), rt))
    src = tmp_path / "src"
    ckpt.save(src, rt, params, state, step=1)
    tool.main([str(src), str(tmp_path / "port"), *argv, "--device", "cpu"])
    jax_tool.reshard(src, tmp_path / "ref", jax_tool.build_new_plan(
        args_of(argv)), verbose=False)
    for d in ("port", "ref"):
        assert (tmp_path / d / "plan.json").exists()
    for f in sorted((tmp_path / "ref").rglob("*")):
        if f.is_file():
            rel = f.relative_to(tmp_path / "ref")
            assert (tmp_path / "port" / rel).read_bytes() == f.read_bytes(), \
                rel
    tool.main([str(tmp_path / "port"), str(tmp_path / "back"), "--tp", "1",
               "--device", "cpu"])
    for g, lo in rt.layouts.items():
        for j in range(lo.outer_size * lo.plan.num_shards):
            name = f"shards/p__{g}__master__{j}.npy"
            assert (tmp_path / "back" / name).read_bytes() == \
                (src / name).read_bytes()


def test_nemotron_config_and_full_width_plans_match_reference():
    """nemotron-4-340b is registered with every field the reference's
    (tp 16, sequence parallelism, 16 microbatches, Adam8bit,
    squared-ReLU), and at published width (one layer) on the production
    mesh ``{"data": 16, "model": 16}`` its plans -- and those of the expert
    parallel configs at ep 16 -- ``dumps()`` string-equal to the
    reference's, on the fp32 and the q8_block store."""
    import dataclasses

    from repro.configs import build_model as jax_build_model
    from repro.configs import get_config as jax_get_config
    from repro.core import policy as jax_policy
    from repro.core.schedule import CommSchedule as JaxSchedule
    from repro_torch.configs import ARCH_IDS, build_model, get_config
    from repro_torch.core import policy
    from repro_torch.core.schedule import CommSchedule

    assert NEMO in ARCH_IDS
    assert dataclasses.asdict(get_config(NEMO)) == \
        dataclasses.asdict(jax_get_config(NEMO))
    mesh = {"data": 16, "model": 16}
    for arch in (NEMO, "qwen3-moe-235b-a22b", "gpt-oss-120b"):
        tm = build_model(dataclasses.replace(get_config(arch), n_layers=1))
        jm = jax_build_model(dataclasses.replace(jax_get_config(arch),
                                                 n_layers=1))
        assert list(tm.groups()) == list(jm.groups())
        for sched in ({}, {"param_store": "q8_block"}):
            got = policy.plan(tm, mesh, CommSchedule(**sched))
            want = jax_policy.plan(jm, mesh, JaxSchedule(**sched))
            assert got.dumps() == want.dumps(), (arch, sched)
