"""One rank of the two-rank serve check in tests/test_torch_serve.py: the
prefill and decode logits of gemma2-2b.reduced() on the fp32 store with
the batch split over the ranks (this module imports no JAX, so spawned
ranks start fast)."""
import numpy as np
import torch

from repro_torch.configs import build_model, get_config
from repro_torch.core.fsdp import FSDPRuntime
from repro_torch.launch.mesh import init_local_group

B, P, K, S = 4, 6, 3, 16


def tokens():
    cfg = get_config("gemma2-2b").reduced()
    return np.random.default_rng(5).integers(0, cfg.vocab, (B, P + K))


def serve_logits(group):
    """Prefill of P tokens, then K - 1 decode steps (scalar index) and one
    with per-row positions; returns the logits of every call, stacked."""
    model = build_model(get_config("gemma2-2b").reduced())
    rt = FSDPRuntime(model, group, compute_dtype=torch.float32, device="cpu")
    params = rt.init_params(0)
    toks = torch.from_numpy(tokens())
    cache = model.init_cache(B, S, device="cpu")
    lg, cache = rt.make_prefill_step()(params, {"tokens": toks[:, :P]},
                                       cache)
    out = [lg]
    decode = rt.make_decode_step()
    for t in range(P, P + K - 1):
        lg, cache = decode(params, {"tokens": toks[:, t:t + 1]}, cache, t)
        out.append(lg)
    t = P + K - 1
    lg, cache = decode(params, {"tokens": toks[:, t:t + 1]}, cache,
                       torch.full((B,), t))
    out.append(lg)
    return torch.stack(out).numpy()


def rank_main(rank, world, init_file, out_prefix):
    torch.set_num_threads(1)
    group = init_local_group("gloo", rank=rank, world_size=world,
                             init_file=init_file)
    np.save(f"{out_prefix}{rank}.npy", serve_logits(group))
    torch.distributed.destroy_process_group()
