"""The quickstart loop of the port, shared by tests/test_torch_train.py's
in-process runs and its spawned multi-rank runs (this module imports no
JAX, so spawned ranks start fast)."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import build_model, get_config
from repro_torch.core.fsdp import FSDPRuntime
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch.mesh import init_local_group
from repro_torch.optim import make_optimizer

LR = 1e-2  # raised from 3e-4 so that five warmup steps move the weights
SEQ, BATCH = 64, 8  # examples/quickstart.py


def quickstart_config(arch="gemma2-2b", **overrides):
    return dataclasses.replace(get_config(arch).reduced(), learning_rate=LR,
                               **overrides)


def train(group, compute_dtype, steps, *, first_step=0, state=None,
          schedule=None, on_step=None, arch="gemma2-2b", overrides=None):
    """Run ``steps`` quickstart steps of ``arch``'s reduced config (with
    the config fields in ``overrides`` replaced) from ``first_step`` under
    ``schedule`` (default: the config's).  ``state``, if given, maps the
    runtime to the ``(params, opt_state)`` to start from (default:
    ``init_params(0)`` and zero moments); ``on_step(i, params)`` sees the
    state after each step.  Returns (losses, grad_norms, runtime, params,
    opt_state)."""
    cfg = quickstart_config(arch, **(overrides or {}))
    rt = FSDPRuntime(build_model(cfg), group, compute_dtype=compute_dtype,
                     device="cpu", schedule=schedule)
    opt = make_optimizer(cfg)
    opt_state = opt.init(rt)
    params = rt.init_params(0)
    if state is not None:
        params, opt_state = state(rt)
    step_fn = rt.make_train_step(opt)
    stream = SyntheticStream(DataConfig(cfg.vocab, SEQ, BATCH), cfg)
    losses, norms = [], []
    step = first_step
    for i in range(first_step, first_step + steps):
        batch = stream.shard(stream.batch(i), rt)
        params, opt_state, step, m = step_fn(params, opt_state, step, batch)
        if on_step is not None:
            on_step(i, params)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, rt, params, opt_state


def rank_main(rank, world, init_file, out_prefix, steps, arch="gemma2-2b",
              overrides=None):
    """Entry point of one spawned rank: train ``arch``'s reduced config
    (``overrides`` as in ``train``) in fp32 compute and save the metric
    streams and this rank's shards."""
    torch.set_num_threads(1)
    group = init_local_group("gloo", rank=rank, world_size=world,
                             init_file=init_file)
    losses, norms, _, params, _ = train(group, torch.float32, steps,
                                        arch=arch, overrides=overrides)
    np.savez(f"{out_prefix}{rank}.npz", losses=np.asarray(losses),
             norms=np.asarray(norms),
             **{k: p.detach().numpy() for k, p in params.items()})
    torch.distributed.destroy_process_group()


def rank_main_runs(rank, world, init_file, out_prefix, steps, runs):
    """``rank_main`` for several configs in one spawn: ``runs`` is a list
    of ``(tag, arch, overrides)``, trained in turn on this rank's one
    group, each saved to ``{out_prefix}{tag}_{rank}.npz``."""
    torch.set_num_threads(1)
    group = init_local_group("gloo", rank=rank, world_size=world,
                             init_file=init_file)
    for tag, arch, overrides in runs:
        losses, norms, _, params, _ = train(group, torch.float32, steps,
                                            arch=arch, overrides=overrides)
        np.savez(f"{out_prefix}{tag}_{rank}.npz", losses=np.asarray(losses),
                 norms=np.asarray(norms),
                 **{k: p.detach().numpy() for k, p in params.items()})
    torch.distributed.destroy_process_group()
