"""One spawned rank of tests/test_torch_train_optim.py's multi-rank runs:
the quickstart loop of the port (``_torch_train_worker.train``) with a
non-element-wise optimizer, saving the metric streams, this rank's
parameter shards and its optimizer state (no JAX, so ranks start fast)."""
import numpy as np
import torch

import _torch_train_worker as W
from repro_torch.launch.mesh import init_local_group


def rank_main(rank, world, init_file, out_prefix, steps, arch, overrides):
    """Train ``arch``'s reduced config with ``overrides`` in fp32 compute on
    rank ``rank`` of ``world`` gloo ranks; write ``{out_prefix}{rank}.npz``
    with ``losses``, ``norms``, ``param/{group}`` and ``state/{key}/{leaf}``
    (the leaf's rank-local share)."""
    torch.set_num_threads(1)
    group = init_local_group("gloo", rank=rank, world_size=world,
                             init_file=init_file)
    losses, norms, _, params, state = W.train(
        group, torch.float32, steps, arch=arch, overrides=overrides)
    out = {"losses": np.asarray(losses), "norms": np.asarray(norms)}
    out.update({f"param/{n}": p.detach().numpy()
                for n, p in params.items()})
    out.update({f"state/{k}/{n}": t.numpy()
                for k, leaves in state.items() for n, t in leaves.items()})
    np.savez(f"{out_prefix}{rank}.npz", **out)
    torch.distributed.destroy_process_group()
