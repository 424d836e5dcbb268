"""Ranks of the multi-rank fp8 checks in tests/test_torch_fp8.py (the fp8
cast reduce-scatter) and tests/test_torch_train_fp8.py (a train run); this
module imports no JAX, so spawned ranks start fast."""
import numpy as np
import torch

import _torch_train_worker as W
from repro_torch.core.schedule import CommSchedule
from repro_torch.core.wire import WireCodec, codec_reduce_scatter
from repro_torch.launch.mesh import init_local_group

FMTS = ("fp8_e4m3", "fp8_e5m2")
# the two-rank train run: the fp8_e4m3 store with the fp8_e5m2 gradient wire
TRAIN_SCHEDULE = dict(param_store="fp8_e4m3", reduce_wire="fp8_e5m2")


def inputs(world: int, n: int) -> np.ndarray:
    """(world, n) cotangents, row r rank r's: magnitudes over seven decades
    (e5m2 subnormals up to sums past e4m3's 464: every 61st element is 250
    on every rank), none past 400, so no single code is NaN and the sums
    decide every overflow."""
    rng = np.random.default_rng([29, world])
    x = rng.standard_normal((world, n)) * 10.0 ** rng.uniform(-5, 2.3,
                                                              (world, n))
    x[:, ::61] = 250.0
    return np.clip(x, -400, 400).astype(np.float32)


def reduce_rank_main(rank, world, init_file, out_prefix, n):
    torch.set_num_threads(1)
    group = init_local_group("gloo", rank=rank, world_size=world,
                             init_file=init_file)
    ct = torch.from_numpy(inputs(world, n)[rank])
    out = {fmt: codec_reduce_scatter(ct, None, WireCodec(fmt), group,
                                     torch.float32).numpy()
           for fmt in FMTS}
    np.savez(f"{out_prefix}{rank}.npz", **out)
    torch.distributed.destroy_process_group()


def train_rank_main(rank, world, init_file, out_prefix, steps):
    """One rank of a quickstart run under ``TRAIN_SCHEDULE``: save the
    metric streams and this rank's codes and master."""
    torch.set_num_threads(1)
    group = init_local_group("gloo", rank=rank, world_size=world,
                             init_file=init_file)
    losses, norms, _, params, _ = W.train(
        group, torch.float32, steps, schedule=CommSchedule(**TRAIN_SCHEDULE))
    np.savez(f"{out_prefix}{rank}.npz", losses=np.asarray(losses),
             norms=np.asarray(norms),
             codes=params["layers"]["codes"].view(torch.uint8).numpy(),
             master=params["layers"]["master"].detach().numpy())
    torch.distributed.destroy_process_group()
