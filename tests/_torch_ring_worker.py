"""Ranks of the multi-rank ring checks in tests/test_torch_ring.py (the
ring and q8 route functions) and tests/test_torch_train_ring.py (train
streams under the ring schedules); this module imports no JAX, so spawned
ranks start fast."""
import dataclasses

import numpy as np
import torch

import _torch_train_worker as W
from repro_torch.core import wire
from repro_torch.core.schedule import APPROX_VARIANTS, VARIANTS
from repro_torch.launch.mesh import init_local_group

ROUTE_N = 4096      # elements per rank's cotangent
Q8_BLOCK = 64
RING_CHUNK = 256    # a fixed ring_chunk_elems (snapped per route)
# the train streams' chunked ring: snapped to 2,564 elements of a
# ``layers`` shard (128 sub-chunks at 2 ranks, 64 at 4) and 3,648 / 2,056
# of ``globals`` (18 / 16), so every message still splits into many
# independent rings; RING_CHUNK there cut a 4-rank shard into 641 and took
# ten times the hops
TRAIN_RING_CHUNK = 4096
# (case name, codec format, gather mode, reduce mode, ring chunk)
ROUTE_CASES = [
    (f"{fmt}_{mode}_{rmode}_{chunk}", fmt, mode, rmode, chunk)
    for fmt in ("fp32", "bf16", "q8_block")
    for mode, rmode in (("ring", "match"), ("ring", "ring_acc"),
                        ("xla", "match"))
    if not (fmt != "q8_block" and mode == "xla")
    for chunk in (None, RING_CHUNK)]

# (run name, schedule, planner, group_schedules) of the train streams
TRAIN_RUNS = {
    "default": (VARIANTS["default"], "ragged", None),
    "ring": (VARIANTS["ring"], "ragged", None),
    "ring_overlap": (VARIANTS["ring_overlap"], "ragged", None),
    "ring_chunked": (dataclasses.replace(VARIANTS["ring"],
                                         ring_chunk_elems=TRAIN_RING_CHUNK),
                     "ragged", None),
    "ring_acc": (APPROX_VARIANTS["ring_acc"], "ragged", None),
    "q8_store": (APPROX_VARIANTS["q8_store"], "ragged", None),
    "q8_ring_prefetch": (APPROX_VARIANTS["q8_ring_prefetch"], "ragged",
                         None),
    "q8_reduce_ring_acc": (APPROX_VARIANTS["q8_reduce_ring_acc"], "ragged",
                           None),
    "fp8_store": (APPROX_VARIANTS["fp8_store"], "ragged", None),
    "fp8_ring_prefetch": (APPROX_VARIANTS["fp8_ring_prefetch"], "ragged",
                          None),
    "globals_unsharded": (VARIANTS["default"], "ragged",
                          {"globals": {"sharded": False}}),
    "fsdp2": (VARIANTS["default"], "fsdp2", None),
    "fsdp2_ring_overlap": (VARIANTS["ring_overlap"], "fsdp2", None),
}


def route_inputs(world: int, n: int = ROUTE_N) -> np.ndarray:
    """(world, n) cotangents, row r rank r's, over five decades."""
    rng = np.random.default_rng([41, world])
    x = rng.standard_normal((world, n)) * 10.0 ** rng.uniform(-3, 2,
                                                              (world, n))
    return x.astype(np.float32)


def shard_inputs(world: int, n: int = ROUTE_N // 4) -> np.ndarray:
    """(world, n) shards for the ring all-gather."""
    return np.random.default_rng([43, world]).standard_normal(
        (world, n)).astype(np.float32)


def routes_main(rank, world, init_file, out_prefix):
    torch.set_num_threads(1)
    group = init_local_group("gloo", rank=rank, world_size=world,
                             init_file=init_file)
    ct = torch.from_numpy(route_inputs(world)[rank])
    out = {}
    for name, fmt, mode, rmode, chunk in ROUTE_CASES:
        codec = wire.WireCodec(fmt, Q8_BLOCK)
        out[name] = wire.codec_reduce_scatter(
            ct, None, codec, group, torch.float32, mode, rmode,
            chunk).numpy()
    x = torch.from_numpy(shard_inputs(world)[rank])
    for chunk in (None, RING_CHUNK // 4):
        out[f"gather_{chunk}"] = wire.payload_all_gather(
            x, group, "ring", chunk).numpy()
        out[f"gather_bf16_{chunk}"] = wire.payload_all_gather(
            x.to(torch.bfloat16), group, "ring", chunk).float().numpy()
    np.savez(f"{out_prefix}{rank}.npz", **out)
    torch.distributed.destroy_process_group()


def train_main(rank, world, init_file, out_prefix, steps, runs):
    """One rank: every run of ``runs`` (names of TRAIN_RUNS) for
    ``steps`` fp32 quickstart steps; saves each run's streams and this
    rank's masters (the whole master of an unsharded group, keyed
    ``name/group=whole``)."""
    from repro_torch.configs import build_model
    from repro_torch.core.fsdp import FSDPRuntime
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.optim import make_optimizer

    torch.set_num_threads(1)
    group = init_local_group("gloo", rank=rank, world_size=world,
                             init_file=init_file)
    out = {}
    for name in runs:
        sched, planner, gs = TRAIN_RUNS[name]
        cfg = W.quickstart_config()
        rt = FSDPRuntime(build_model(cfg), group, compute_dtype=torch.float32,
                         device="cpu", schedule=sched, planner=planner,
                         group_schedules=gs)
        opt = make_optimizer(cfg)
        state = opt.init(rt)
        params = rt.init_params(0)
        step_fn = rt.make_train_step(opt)
        stream = SyntheticStream(DataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
        metrics, step = [], 0
        for i in range(steps):
            params, state, step, m = step_fn(
                params, state, step, stream.shard(stream.batch(i), rt))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[f"{name}/metrics"] = np.asarray(metrics)
        for k, v in params.items():
            v = v["master"] if isinstance(v, dict) else v
            whole = "" if rt.layouts[k].sharded else "=whole"
            out[f"{name}/{k}{whole}"] = v.detach().numpy()
    np.savez(f"{out_prefix}{rank}.npz", **out)
    torch.distributed.destroy_process_group()
