"""Sharded checkpointing of the optimizers' states and across world sizes
(the second half of tests/test_torch_ckpt.py, whose helpers it uses), on
gemma2-2b.reduced() after two steps:

  * Adam8bit (int8 moment codes and block scales), Muon and Shampoo (its
    factors stored unpadded): the reference saves and the port loads
    bitwise, the port's re-save is byte-identical file by file, and the
    reference loads the port's files bitwise;
  * two gloo ranks save (each rank its own shard files); one and four
    ranks load, bitwise on masters and moments tensor by tensor, and
    train on; the two ranks' in-job ``replan`` (to the fsdp2 planner, to
    the q8_block store with the q8 gradient wire) moves the same tensors.

Parity class: BITWISE; the third step's losses across worlds ALLCLOSE
(stated in the test).
"""
import multiprocessing

import numpy as np
import pytest
import torch

import _torch_ckpt_worker as CW
import _torch_train_worker as W
from test_torch_ckpt import _round_trip, _same_tensors

from repro_torch.configs import build_model
from repro_torch.core.policy import plan as make_plan

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["adam8bit", "muon", "shampoo"])
def test_optimizer_state_round_trip(case, tmp_path):
    """Every optimizer leaf bitwise across the two packages, in both
    directions, with byte-identical files (Shampoo's factor files hold the
    unpadded (L, k, k) stacks)."""
    rt, _, _, state = _round_trip(case, tmp_path)
    if case == "shampoo":
        factors = sorted((tmp_path / "port" / "shards").glob("o__0*.npy"))
        stacks = [np.load(f) for f in factors if f.name.count("__") == 1]
        assert stacks and all(a.shape[0] == rt.layouts["layers"].n_layers
                              for a in stacks)


def _spawn(world, tmp_path, tag, mode, ckpt_dir, steps=1):
    ctx = multiprocessing.get_context("spawn")
    init_file, prefix = str(tmp_path / f"{tag}_store"), str(tmp_path / tag)
    procs = [ctx.Process(target=CW.rank_main,
                         args=(r, world, init_file, mode, str(ckpt_dir),
                               prefix, None, steps))
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


def _global_tensors(world, outs, key, policies=None, planner="ragged"):
    """{(tensor, layer): array} of a ``world``-rank state's leaf ``key``
    (``p/<group>`` or ``o/<k>/<group>``), its ranks' shards concatenated
    and unpacked through the quickstart plan at that world size."""
    from repro_torch.core.dbuffer import DBuffer

    p = make_plan(build_model(W.quickstart_config()),
                  {"data": world, "model": 1}, policies, planner=planner,
                  compute_dtype=torch.float32)
    out = {}
    for name, e in p.groups.items():
        a = np.concatenate([o[f"{key}/{name}"] for o in outs], axis=-1) \
            if e.fsdp_axes else outs[0][f"{key}/{name}"]
        buf = DBuffer(e.plan)
        for li in (range(e.n_layers) if e.n_layers else [None]):
            for k, v in buf.unpack_np(a[li] if li is not None else a).items():
                out[k, li] = v
    return out


def test_two_ranks_save_one_and_four_load(tmp_path):
    """Two gloo ranks train two quickstart steps and save (each rank its
    own shard files); one and four ranks load: masters and moments bitwise
    the two ranks' tensor by tensor; every world trains a third step to
    the same loss within 1e-6 (measured: 6.7e-8)."""
    saved = _spawn(2, tmp_path, "save", "save", tmp_path / "c")
    assert len(list((tmp_path / "c" / "shards").glob("p__layers__*"))) == 2
    loads = {w: _spawn(w, tmp_path, f"load{w}", "load", tmp_path / "c")
             for w in (1, 4)}
    for key in ("p", "o/m", "o/v"):
        want = _global_tensors(2, saved, key)
        for w, outs in loads.items():
            _same_tensors(_global_tensors(w, outs, key), want)
    # the saving ranks' replans: the same tensors under the new plans
    for tag, (pol, pl) in {"fsdp2": (None, "fsdp2"),
                           "q8": (CW.REPLANS["q8"]["schedule"],
                                  "ragged")}.items():
        for key in ("p", "o/m", "o/v"):
            _same_tensors(_global_tensors(2, saved, f"{tag}/{key}", pol, pl),
                          _global_tensors(2, saved, key))
    losses = [o["losses"][0] for outs in loads.values() for o in outs]
    assert all(int(o["step"]) == CW.SAVE_STEPS
               for outs in loads.values() for o in outs)
    np.testing.assert_allclose(losses, losses[0], rtol=1e-6)
