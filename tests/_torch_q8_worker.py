"""One rank of the two-rank q8 checks in tests/test_torch_quant.py (the
reduce-scatter) and tests/test_torch_train_q8.py (a train run); this module
imports no JAX, so spawned ranks start fast."""
import numpy as np
import torch

import _torch_train_worker as W
from repro_torch.core.schedule import CommSchedule
from repro_torch.core.wire import WireCodec, codec_reduce_scatter
from repro_torch.launch.mesh import init_local_group

BLOCK = 64


def inputs(world: int, n: int):
    """Each rank's bf16-representable cotangent and fp32 residual, from a
    numpy seed per rank."""
    cts, efs = [], []
    for r in range(world):
        rng = np.random.default_rng([17, r])
        cts.append((rng.standard_normal(n) * rng.uniform(0.01, 5.0))
                   .astype(np.float32))
        efs.append((rng.standard_normal(n) * 1e-3).astype(np.float32))
    return cts, efs


def rank_main(rank, world, init_file, out_prefix, n):
    torch.set_num_threads(1)
    group = init_local_group("gloo", rank=rank, world_size=world,
                             init_file=init_file)
    cts, efs = inputs(world, n)
    ef = torch.from_numpy(efs[rank].copy())
    shard = codec_reduce_scatter(torch.from_numpy(cts[rank]), ef,
                                 WireCodec("q8_block", BLOCK), group,
                                 torch.float32)
    np.savez(f"{out_prefix}{rank}.npz", shard=shard.numpy(), ef=ef.numpy())
    torch.distributed.destroy_process_group()


def train_rank_main(rank, world, init_file, out_prefix, steps):
    """One rank of a ``q8_both_wires`` quickstart run: save the metric
    streams and this rank's residual."""
    torch.set_num_threads(1)
    group = init_local_group("gloo", rank=rank, world_size=world,
                             init_file=init_file)
    losses, norms, _, params, _ = W.train(
        group, torch.float32, steps,
        schedule=CommSchedule(param_store="q8_block",
                              reduce_wire="q8_block"))
    np.savez(f"{out_prefix}{rank}.npz", losses=np.asarray(losses),
             norms=np.asarray(norms),
             ef=params["layers"]["reduce_ef"].numpy())
    torch.distributed.destroy_process_group()
