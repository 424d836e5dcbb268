"""Checkpoints and ``replan`` across the model axis on 4 gloo ranks:
nemotron-4-340b.reduced() at the reference's tp-scenario widths (4 heads,
2 KV heads, head_dim 64, d_model 256, d_ff 512), AdamW, fp32 compute.

  * format v2 across the model axis: a step-0 save on data 2 x model 2
    (tp 2) is byte for byte the reference's save on as many host devices
    (a JAX subprocess with 4), every file;
  * after two steps, that (2, 2) checkpoint loads on data 4 (tp 1) and on
    data 1 x model 4 (tp 4: the KV projections replicated, wk and wv
    moving from ``layers`` into ``layers_rep``) and on (2, 2) again: the
    master and both moments, every tensor whole, BITWISE the saved run's;
  * ``replan`` on one process group, data 4 -> (2, 2) tp 2 -> (1, 4) tp 4
    -> data 4: the state whole after each hop BITWISE, and the next step
    after the round trip BITWISE the step without it; the step at tp 4
    within the tp class of ``tests/test_torch_tp.py`` (loss 1e-6, grad
    norm 1e-5 relative); a replan that changes only ``globals``' schedule
    keeps ``layers`` and ``layers_rep`` as they are (the same tensors).
"""
import json
import os

import numpy as np
import pytest

import _torch_mesh_worker as MW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    ref_out = str(tmp / "ref.npz")
    ref = MW.start_reference_extra(os.path.join(ROOT, "src"), ref_out, {},
                                   ckpt0=str(tmp / "ref0"))
    procs = MW.spawn(4, tmp, {}, ckpt_dir=str(tmp))
    outs = MW.join(*procs)
    assert ref.wait(timeout=300) == 0
    return {"ranks": outs, "dir": tmp}


def test_step0_checkpoint_on_a_model_axis_is_the_references(checked):
    """Every file of the port's (2, 2) tp-2 save at init -- meta.json,
    plan.json, the parameter rows ``r * m + k`` and the moments' -- is the
    reference's byte for byte."""
    port, ref = checked["dir"] / "port0", checked["dir"] / "ref0"
    files = sorted(p.relative_to(port) for p in port.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(ref) for p in ref.rglob("*")
                           if p.is_file())
    assert len(files) > 20
    for f in files:
        assert (port / f).read_bytes() == (ref / f).read_bytes(), f
    meta = json.loads((port / "meta.json").read_text())
    assert meta["groups"]["layers"]["outer_size"] == 2


@pytest.mark.parametrize("mesh", ["4x1", "1x4", "2x2"])
def test_checkpoint_loads_across_tp_degrees(mesh, checked):
    """The (2, 2) tp-2 checkpoint after two steps, loaded on ``mesh``: the
    master and the AdamW moments bitwise on every rank; at tp 4 wk and wv
    sit in ``layers_rep``."""
    for o in checked["ranks"]:
        assert bool(o[f"ck/load{mesh}"])
    groups = json.loads(str(checked["ranks"][0][f"ck/load{mesh}/groups"]))
    if mesh == "1x4":
        assert {"wk", "wv"} <= set(groups["layers_rep"])
    else:
        assert {"wk", "wv"} <= set(groups["layers"])


@pytest.mark.parametrize("hop", ["2x2", "1x4", "4x1"])
def test_replan_onto_and_across_a_model_axis(hop, checked):
    """After each hop of data 4 -> (2, 2) tp 2 -> (1, 4) tp 4 -> data 4 the
    master and moments are bitwise data 4's."""
    for o in checked["ranks"]:
        assert bool(o[f"replan/{hop}"])


def test_replan_round_trip_resumes_training(checked):
    """The step after the round trip is bitwise the step without it; the
    step at tp 4 within the tp class (measured: loss 6.0e-8, grad norm
    2.0e-7 relative); unchanged groups keep their tensors."""
    o = checked["ranks"][0]
    direct, resumed = o["replan/direct"], o["replan/resumed"]
    assert np.array_equal(resumed, direct)
    tp4 = o["replan/tp4_step"]
    assert tp4[0] == pytest.approx(direct[0], rel=1e-6)
    assert tp4[1] == pytest.approx(direct[1], rel=1e-5)
    for r in checked["ranks"]:
        assert list(r["replan/kept"]) == ["layers", "layers_rep"]
        assert bool(r["replan/kept_state"])
