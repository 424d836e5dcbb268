"""Spawned gloo ranks of tests/test_torch_ckpt.py and
tests/test_torch_reshard.py: train and save, or load and train on, a
checkpoint of the port's quickstart config (imports no JAX, so ranks start
fast)."""
import numpy as np
import torch

import _torch_train_worker as W
from repro_torch.checkpoint import ckpt
from repro_torch.configs import build_model
from repro_torch.core.fsdp import FSDPRuntime
from repro_torch.core.schedule import CommSchedule
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch.mesh import init_local_group
from repro_torch.optim import make_optimizer

SAVE_STEPS = 2
# the replans a saving rank also runs: tag -> FSDPRuntime.replan keywords
REPLANS = {"fsdp2": {"planner": "fsdp2"},
           "q8": {"schedule": CommSchedule(param_store="q8_block",
                                           reduce_wire="q8_block")}}


def _host(params, opt_state):
    """Copies of this rank's masters and optimizer leaves as host
    arrays (the train step updates the tensors in place)."""
    out = {f"p/{n}": (p["master"] if isinstance(p, dict) else p)
           .detach().float().numpy().copy() for n, p in params.items()}
    out.update({f"o/{k}/{n}": t.numpy().copy()
                for k, leaves in opt_state.items()
                for n, t in leaves.items()})
    return out


def rank_main(rank, world, init_file, mode, ckpt_dir, out_prefix,
              overrides=None, steps=1):
    """``mode="save"``: train ``SAVE_STEPS`` quickstart steps (fp32
    compute), save them to ``ckpt_dir`` and replan the state as in
    ``REPLANS``; ``mode="load"``: load
    ``ckpt_dir`` and train ``steps`` more.  Each rank writes its state
    right after the save (and each replan's, its keys prefixed with the
    tag) or the load, and the losses, to ``{out_prefix}{rank}.npz``."""
    torch.set_num_threads(1)
    group = init_local_group("gloo", rank=rank, world_size=world,
                             init_file=init_file)
    if mode == "save":
        _, _, rt, params, opt_state = W.train(group, torch.float32,
                                              SAVE_STEPS,
                                              overrides=overrides)
        ckpt.save(ckpt_dir, rt, params, opt_state, step=SAVE_STEPS)
        out = _host(params, opt_state)
        # replan in the job, over the two ranks' gathers
        opt = make_optimizer(rt.cfg)
        for tag, kw in REPLANS.items():
            _, p2, s2 = rt.replan(params, opt_state, optimizer=opt, **kw)
            out.update({f"{tag}/{k}": v for k, v in _host(p2, s2).items()})
        np.savez(f"{out_prefix}{rank}.npz", **out)
    else:
        cfg = W.quickstart_config(**(overrides or {}))
        rt = FSDPRuntime(build_model(cfg), group,
                         compute_dtype=torch.float32, device="cpu")
        opt = make_optimizer(cfg)
        params, step, opt_state = ckpt.load(ckpt_dir, rt, opt.init(rt))
        state = _host(params, opt_state)
        step_fn = rt.make_train_step(opt)
        stream = SyntheticStream(DataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
        losses = []
        for i in range(step, step + steps):
            params, opt_state, _, m = step_fn(
                params, opt_state, i, stream.shard(stream.batch(i), rt))
            losses.append(float(m["loss"]))
        np.savez(f"{out_prefix}{rank}.npz", losses=np.asarray(losses),
                 step=step, **state)
    torch.distributed.destroy_process_group()
