"""Ranks of the model-axis, pod-axis and accumulation checks
(tests/test_torch_tp.py, tests/test_torch_ep.py, tests/test_torch_micro.py,
tests/test_torch_hsdp.py, tests/test_torch_tp_ckpt.py,
tests/test_torch_tp_serve.py): short fp32 train streams on a ``(data,
model)`` or ``(pod, data, model)`` gloo mesh, each rank writing the metric
streams and, on rank 0, every tensor's final master whole (outer rows
joined, FSDP shards concatenated); the serve steps, checkpoints and
``replan`` across the model axis.  This module imports no JAX, so
spawned ranks start fast; the tests' one-rank runs call ``run`` in
process."""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import build_model, get_config, with_tp
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.fsdp import FSDPRuntime, load_reference_state
from repro_torch.core.schedule import CommSchedule
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch.mesh import init_local_group, make_local_mesh
from repro_torch.optim import make_optimizer

LR = 1e-2
STEPS = 3
# the reference's tp scenario widths (tests/test_multidevice.py)
TP_WIDTHS = dict(n_heads=4, n_kv_heads=2, head_dim=64, d_model=256,
                 d_ff=512, optimizer="adamw")


# the VLM's gates (x_gate, c_gate): both packages' init starts them at 0,
# where the cross layers' weights get no gradient at the first step; the
# vision tests start them at this value in both (``gated_init``)
GATE = 0.5


def gated_init(init_tensor, value: float = GATE):
    """``FSDPRuntime._init_tensor`` with the VLM's gates at ``value``: a
    staticmethod for either package's runtime class."""
    def init(spec, seed, layer):
        if spec.name in ("x_gate", "c_gate"):
            return np.full(spec.shape, value, np.float32)
        return init_tensor(spec, seed, layer)

    return staticmethod(init)


def config(arch: str, par: dict, **fields):
    """``arch``'s reduced config at the lr above, its parallel config
    ``ParallelConfig(**par)`` and ``fields`` replaced (nemotron at the
    ``TP_WIDTHS``)."""
    par = {k: tuple(v) if isinstance(v, list) else v for k, v in par.items()}
    cfg = get_config(arch).reduced()
    if arch == "nemotron-4-340b":
        fields = {**TP_WIDTHS, **fields}
    return dataclasses.replace(cfg, learning_rate=LR,
                               parallel=ParallelConfig(**par), **fields)


def full_tensors(rt, params, raw=False) -> dict[str, np.ndarray]:
    """Every tensor's master whole, on every rank: the groups' local
    blocks all-gathered over the process group and laid out by block
    index (outer row, then FSDP shard), each outer row unpacked, split
    tensors joined on their outer dim; a tensor every outer row holds
    whole must be the same bits in each.  ``raw``: ``params`` maps each
    group to a plain fp32 buffer of its layout (an optimizer moment)."""
    world = dist.get_world_size(rt.group)
    out = {}
    for name, lo in rt.layouts.items():
        t = params[name] if raw else lo.store.trainable(params[name])
        t = t.detach().float().contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=rt.group)
        m = int(np.prod(lo.fsdp_axis_sizes)) if lo.sharded else 1
        glob = np.zeros(lo.global_shape(), np.float32)
        n = t.shape[-1]
        for q, part in enumerate(parts):
            coords = rt.mesh.coords_of(q)
            r = coords[lo.outer_axis] if lo.outer_axis else 0
            f = 0
            for a, size in zip(lo.fsdp_axes, lo.fsdp_axis_sizes):
                f = f * size + coords[a]
            i = r * m + f
            glob[..., i * n:(i + 1) * n] = part.numpy()
        rows = glob.reshape(glob.shape[:-1] + (lo.outer_size,
                                               lo.plan.total))
        layers = range(lo.n_layers) if lo.n_layers else [None]
        for s in lo.gdef.specs:
            per_layer = []
            for li in layers:
                row = rows if li is None else rows[li]
                got = [lo.buffer.unpack_np(row[r])[s.name]
                       for r in range(lo.outer_size)]
                sd = lo.gdef.outer.get(s.name)
                if sd is None or lo.outer_size == 1:
                    for g in got[1:]:
                        assert np.array_equal(g.view(np.int32),
                                              got[0].view(np.int32)), s.name
                    per_layer.append(got[0])
                else:
                    per_layer.append(np.concatenate(got, axis=sd.dim))
            out[s.name] = (np.stack(per_layer) if lo.n_layers
                           else per_layer[0])
    return out


def run(mesh_or_group, cfg, steps=STEPS, schedule=None, seq=32, batch=4,
        keep_ef=False, save=None):
    """``steps`` fp32 steps of ``cfg`` on ``mesh_or_group``; returns
    ``{"metrics": (steps, 2) loss and grad norm, tensor: master, ...}``
    (with ``keep_ef``, each q8 group's residual rows of this rank after
    the last step as ``ef/<group>``, after the first as ``ef1/<group>``).
    ``save``: a directory the run's state is checkpointed to at the end
    (``ckpt.save``, step ``steps``)."""
    rt = FSDPRuntime(build_model(cfg), mesh_or_group,
                     compute_dtype=torch.float32, device="cpu",
                     **schedule_kwargs(schedule))
    opt = make_optimizer(cfg)
    state = opt.init(rt)
    params = rt.init_params(0)
    fn = rt.make_train_step(opt)
    stream = SyntheticStream(DataConfig(cfg.vocab, seq, batch), cfg)
    metrics = []
    step = 0
    out = {}
    for i in range(steps):
        params, state, step, m = fn(params, state, step,
                                    stream.shard(stream.batch(i), rt))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        for name, s in params.items():
            if keep_ef and isinstance(s, dict) and "reduce_ef" in s:
                key = "ef" if i == steps - 1 else "ef1" if i == 0 else None
                if key:
                    out[f"{key}/{name}"] = s["reduce_ef"].numpy().copy()
    out["metrics"] = np.asarray(metrics)
    out.update(full_tensors(rt, params))
    if save:
        from repro_torch.checkpoint import ckpt

        ckpt.save(save, rt, params, state, step=steps)
    return out


def schedule_kwargs(schedule) -> dict:
    """A run's schedule entry as ``FSDPRuntime`` keywords: a
    ``CommSchedule``'s fields, and per-group overrides under
    ``"group_schedules"``."""
    sched = dict(schedule or {})
    groups = sched.pop("group_schedules", None)
    out = {"schedule": CommSchedule(**sched) if sched else None}
    if groups:
        out["group_schedules"] = groups
    return out


def make_mesh(data, model):
    """The ``(data, model)`` mesh, or ``(pod, data, model)`` where ``data``
    is a pair ``(pod, data)``."""
    if isinstance(data, (list, tuple)):
        return make_local_mesh(data[1], model, pod=data[0])
    return make_local_mesh(data, model)


def rank_main(rank, world, init_file, out_prefix, runs, seq=32, batch=4,
              init=(), ref_init=None, functions=False, serve=None,
              engine=None, cli=None, ckpt_dir=None, saves=None,
              gates=False):
    """One spawned rank: ``runs`` is ``{name: (data, model, arch, par,
    fields, schedule)}``; saves ``<prefix><rank>.npz`` with keys
    ``name/metrics``, ``name/<tensor>`` (rank 0) and ``name/ef/<group>``,
    ``name/ef1/<group>`` (every rank).  ``init``: runs whose ``init_params`` this rank keeps
    (``init/<name>/<group>``) and, once the reference's file ``ref_init``
    exists, whose reference state it loads through ``load_reference_state``
    (``load/<name>/<group>/<leaf>``).  ``functions``: the vocab-parallel
    function checks (``vocab_functions``) on a model-axis mesh of all the
    ranks, with a checkpoint round trip and the serve steps there.
    ``serve``: ``{name: (data, model, config, schedule)}`` runs of
    ``serve_logits`` (``serve/<name>``, every rank; ``serve_narrowed/``
    the same on ``narrowed_cache``; ``cache/<name>/...`` its cache bytes
    and the global cache's error); ``engine``: ``(data,
    model, tp, kv)`` of one ``engine_tokens`` run (``engine``, as JSON);
    ``cli``: ``(data, model, tp, kv)`` of one run of the serve command's
    ``launch.serve.serve`` (``cli``: its tokens).
    ``ckpt_dir``: the checkpoint and replan checks of ``ckpt_checks``.
    ``saves``: ``{run: directory}`` runs whose final state is saved.
    ``gates``: the VLM's gates start at ``GATE`` (``gated_init``)."""
    torch.set_num_threads(1)
    if gates:
        FSDPRuntime._init_tensor = gated_init(FSDPRuntime._init_tensor)
    init_local_group("gloo", rank=rank, world_size=world,
                     init_file=init_file)
    out = {}
    meshes = {}

    def mesh(data, model):
        key = (tuple(data) if isinstance(data, (list, tuple)) else data,
               model)
        if key not in meshes:
            meshes[key] = make_mesh(data, model)
        return meshes[key]

    for name, (data, model, arch, par, fields, sched) in runs.items():
        res = run(mesh(data, model), config(arch, par, **fields),
                  schedule=sched, seq=seq, batch=batch, keep_ef=True,
                  save=(saves or {}).get(name))
        for k, v in res.items():
            if rank == 0 or k == "metrics" or k.startswith("ef"):
                out[f"{name}/{k}"] = v
    for name, (data, model, cfg, sched) in (serve or {}).items():
        info = {}
        out[f"serve/{name}"] = serve_logits(mesh(data, model), cfg, sched,
                                            info=info)
        out[f"serve_narrowed/{name}"] = serve_logits(
            mesh(data, model), cfg, sched, narrowed=True)
        for k, v in info.items():
            out[f"cache/{name}/{k}"] = np.asarray(v)
    if engine:
        import json

        data, model, tp, kv = engine
        out["engine"] = np.asarray(json.dumps(
            engine_tokens(mesh(data, model), tp, kv)))
    if cli:
        from repro_torch.launch import serve as serve_cli

        data, model, tp, kv = cli
        args = serve_cli.parse_args(
            ["--data", str(data), "--model", str(model), "--device", "cpu",
             "--batch", "2", "--prompt-len", "4", "--gen", "3"])
        out["cli"] = np.asarray(serve_cli.serve(serve_config(tp, kv), args,
                                                dist.group.WORLD))
    if ckpt_dir:
        out.update(ckpt_checks(mesh, ckpt_dir, rank))
    if functions:
        out.update(vocab_functions(mesh(1, world)))
        # a q8 reduce wire on the model-replicated group: the reference's
        # ValueError (each replica would keep its own residual)
        cfg = config("nemotron-4-340b", dict(fsdp_axes=("data",),
                                             batch_axes=("data",), tp=world))
        rt = FSDPRuntime(build_model(cfg), mesh(1, world), device="cpu",
                         schedule=CommSchedule(reduce_wire="q8_block"))
        try:
            rt.make_train_step(make_optimizer(cfg))
            out["err/q8_layers_rep"] = np.asarray("")
        except ValueError as e:
            out["err/q8_layers_rep"] = np.asarray(str(e))
        # Muon and Shampoo initialise on outer-split groups
        for opt in ("muon", "shampoo"):
            try:
                make_optimizer(dataclasses.replace(cfg, optimizer=opt)) \
                    .init(rt)
                out[f"err/{opt}"] = np.asarray("")
            except NotImplementedError as e:
                out[f"err/{opt}"] = np.asarray(str(e))
        # a checkpoint round trip on the (1, world) mesh, and the serve
        # steps there (one KV head: tp passes it, the replicated-KV layout)
        from repro_torch.checkpoint import ckpt

        rt = FSDPRuntime(build_model(cfg), mesh(1, world), device="cpu",
                         compute_dtype=torch.float32)
        opt = make_optimizer(cfg)
        stream = SyntheticStream(DataConfig(cfg.vocab, seq, batch), cfg)
        params, state, _, _ = rt.make_train_step(opt)(
            rt.init_params(0), opt.init(rt), 0,
            stream.shard(stream.batch(0), rt))
        path = f"{out_prefix}ckpt"
        ckpt.save(path, rt, params, state, step=3)
        loaded, step, lstate = ckpt.load(path, rt, state)
        out["ck/step"] = np.asarray(step)
        out["ck/master_equal"] = np.asarray(all(
            torch.equal(loaded[g], params[g]) for g in params))
        out["ck/moments_equal"] = np.asarray(all(
            torch.equal(lstate[k][g], state[k][g])
            for k in state for g in state[k]))
        out["ck/files"] = np.asarray(sorted(
            f.name for f in __import__("pathlib").Path(path, "shards")
            .iterdir()))
        out["serve/fn"] = serve_logits(mesh(1, world),
                                       serve_config(world, 1))
    if init:
        import os
        import time

        rts = {}
        for name in init:
            data, model, arch, par, fields, sched = runs[name]
            rt = FSDPRuntime(build_model(config(arch, par, **fields)),
                             mesh(data, model), device="cpu",
                             **schedule_kwargs(sched))
            rts[name] = rt
            for g, st in rt.init_params(0).items():
                out[f"init/{name}/{g}"] = \
                    rt.layouts[g].store.trainable(st).detach().numpy()
        deadline = time.time() + 240
        while not os.path.exists(ref_init) and time.time() < deadline:
            time.sleep(0.5)
        ref = dict(np.load(ref_init))
        for name, rt in rts.items():
            state = {}
            for g, lo in rt.layouts.items():
                keys = lo.store.state_keys()
                got = {k: ref[f"init/{name}/{g}/{k}"]
                       for k in (keys or ("master",))}
                state[g] = got if keys else got["master"]
            loaded, _ = load_reference_state(rt, state)
            for g, st in loaded.items():
                leaves = st if isinstance(st, dict) else {"master": st}
                for k, v in leaves.items():
                    out[f"load/{name}/{g}/{k}"] = v.detach().numpy()
    np.savez(f"{out_prefix}{rank}.npz", **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# serving across the model axis (tests/test_torch_tp_serve.py)
# ---------------------------------------------------------------------------

SERVE_B, SERVE_P, SERVE_DECODES = 4, 8, 2
Q8_SERVE = {"param_store": "q8_block", "serve_quant_matmul": True}


def serve_config(tp: int, kv: int, layers: int = 2):
    """gemma2-2b.reduced() with ``kv`` KV heads and ``layers`` layers,
    tensor parallel of degree ``tp`` above 1 (``configs.with_tp``)."""
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              n_kv_heads=kv, n_layers=layers)
    return with_tp(cfg, tp) if tp > 1 else cfg


def serve_tokens(vocab: int, seed: int = 11):
    """The prompts (B, P) and the tokens the decode calls are fed
    (B, decodes): teacher-forced, the same for every run."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (SERVE_B, SERVE_P)),
            rng.integers(0, vocab, (SERVE_B, SERVE_DECODES)))


def narrowed_cache(rt, model, batch, max_len):
    """The model's global cache narrowed to this rank's rows and, under
    tp, its KV head slot: strided views of a cache every rank holds whole
    (the layout the rank-local cache must serve bitwise)."""
    full = model.init_cache(batch, max_len, device="cpu")
    lo, hi = rt.batch_slice(batch)
    bdims = model.cache_batch_dims()
    hdims = model.cache_head_dims() if rt.tp > 1 else {}
    out = {}
    for k, t in full.items():
        t = t.narrow(bdims[k], lo, hi - lo)
        if k in hdims:
            t = t.narrow(hdims[k], rt.mesh.coords["model"], 1)
        out[k] = t
    return out


def serve_logits(mesh_or_group, cfg, sched=None, narrowed=False,
                 info=None):
    """Prefill and ``SERVE_DECODES`` decode calls of ``cfg``, fp32
    compute, on the runtime's rank-local cache (``init_cache``; with
    ``narrowed``, on ``narrowed_cache``); returns the logits (calls, B, 1,
    V) this rank got.  ``info`` (a dict) receives the bytes of each cache
    leaf this rank holds and of the global cache, and the error a step
    raises when it is given the global cache."""
    model = build_model(cfg)
    rt = FSDPRuntime(model, mesh_or_group, compute_dtype=torch.float32,
                     device="cpu", **schedule_kwargs(sched))
    params = rt.init_params(0)
    prompt, feed = serve_tokens(cfg.vocab)
    W = SERVE_P + SERVE_DECODES + 1
    cache = (narrowed_cache(rt, model, SERVE_B, W) if narrowed
             else rt.init_cache(SERVE_B, W))
    if info is not None:
        full = model.init_cache(SERVE_B, W, device="cpu")
        info.update({f"bytes/{k}": t.nbytes for k, t in cache.items()})
        info.update({f"global_bytes/{k}": t.nbytes for k, t in full.items()})
        try:
            rt.make_prefill_step()(
                params, {"tokens": torch.from_numpy(prompt)}, full)
            info["err"] = ""
        except ValueError as e:
            info["err"] = str(e)
    logits, cache = rt.make_prefill_step()(
        params, {"tokens": torch.from_numpy(prompt)}, cache)
    out = [logits]
    decode = rt.make_decode_step()
    for i in range(SERVE_DECODES):
        logits, cache = decode(
            params, {"tokens": torch.from_numpy(feed[:, i:i + 1])}, cache,
            SERVE_P + i)
        out.append(logits)
    return torch.stack(out).float().numpy()


def engine_tokens(mesh_or_group, tp, kv, n_requests=6):
    """``ServeEngine`` (pool 4) on ``n_requests`` seeded requests of 3-9
    prompt tokens, 5 new tokens each: {uid: generated tokens}."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = serve_config(tp, kv)
    model = build_model(cfg)
    rt = FSDPRuntime(model, mesh_or_group, compute_dtype=torch.float32,
                     device="cpu")
    eng = ServeEngine(rt, model, rt.init_params(0), pool=4, max_len=32)
    rng = np.random.default_rng(3)
    for uid in range(n_requests):
        eng.submit(Request(uid, rng.integers(0, cfg.vocab,
                                             int(rng.integers(3, 10))),
                           max_new=5))
    return {r.uid: list(r.out) for r in eng.run()}


# ---------------------------------------------------------------------------
# checkpoints and replan across the model axis (tests/test_torch_tp_ckpt.py)
# ---------------------------------------------------------------------------

def _tp_par(tp: int) -> dict:
    return dict(fsdp_axes=("data",), batch_axes=("data",), tp=tp)


def bitwise(a: dict, b: dict) -> bool:
    """Every array of ``b`` the same bits in ``a``."""
    return sorted(a) == sorted(b) and all(
        np.array_equal(np.asarray(a[k]).view(np.int32),
                       np.asarray(b[k]).view(np.int32)) for k in b)


def state_tensors(rt, params, opt_state) -> dict:
    """The master and the AdamW moments, every tensor whole
    (``full_tensors``), keyed ``master/<t>``, ``m/<t>``, ``v/<t>``."""
    out = {f"master/{k}": v for k, v in full_tensors(rt, params).items()}
    for key in ("m", "v"):
        out.update({f"{key}/{k}": v for k, v in full_tensors(
            rt, opt_state[key], raw=True).items()})
    return out


def ckpt_checks(mesh, ckpt_dir: str, rank: int) -> dict:
    """On 4 ranks, nemotron at the ``TP_WIDTHS`` (2 KV heads), AdamW:
    a step-0 save on (2, 2) at tp 2 (``port0``, for the byte comparison
    with the reference's); two steps there, a save (``c22``) and its loads
    on (4, 1) at tp 1 and on (1, 4) at tp 4 (replicated KV: wk and wv in
    ``layers_rep``), master and moments whole against the saved run's;
    ``replan`` data 4 -> (2, 2) tp 2 -> (1, 4) tp 4 -> data 4, the state
    whole after each hop against data 4's, then a step against the step
    without the hops; a replan that changes only ``globals``' schedule
    keeps the other groups' tensors."""
    from repro_torch.checkpoint import ckpt

    def runtime(data, model, tp, **kw):
        cfg = config("nemotron-4-340b", _tp_par(tp))
        return cfg, FSDPRuntime(build_model(cfg), mesh(data, model),
                                compute_dtype=torch.float32, device="cpu",
                                **kw)

    out = {}
    cfg, rt = runtime(2, 2, 2)
    opt = make_optimizer(cfg)
    params, state = rt.init_params(0), opt.init(rt)
    ckpt.save(f"{ckpt_dir}/port0", rt, params, state, step=0)
    stream = SyntheticStream(DataConfig(cfg.vocab, 32, 4), cfg)
    fn = rt.make_train_step(opt)
    step = 0
    for i in range(2):
        params, state, step, _ = fn(params, state, step,
                                    stream.shard(stream.batch(i), rt))
    ckpt.save(f"{ckpt_dir}/c22", rt, params, state, step=step)
    want = state_tensors(rt, params, state)
    for data, model, tp in ((4, 1, 1), (1, 4, 4), (2, 2, 2)):
        cfg2, rt2 = runtime(data, model, tp)
        p2, s2, o2 = ckpt.load(f"{ckpt_dir}/c22", rt2,
                               make_optimizer(cfg2).init(rt2))
        key = f"ck/load{data}x{model}"
        out[key] = np.asarray(bitwise(state_tensors(rt2, p2, o2), want))
        out[key + "/groups"] = np.asarray(json_of(
            {g: sorted(lo.plan.names) for g, lo in rt2.layouts.items()}))

    # replan across the model axis on one process group
    cfg, rt = runtime(4, 1, 1)
    opt = make_optimizer(cfg)
    params, state = rt.init_params(0), opt.init(rt)
    fn = rt.make_train_step(opt)
    for i in range(2):
        params, state, _, _ = fn(params, state, i,
                                 stream.shard(stream.batch(i), rt))
    want = state_tensors(rt, params, state)
    batch2 = stream.batch(2)
    # a step updates its state in place: the comparisons step copies
    _, _, _, m = fn(clone(params), clone(state), 2, stream.shard(batch2, rt))
    out["replan/direct"] = np.asarray([float(m["loss"]),
                                       float(m["grad_norm"])])
    cur, p, st = rt, params, state
    for data, model, tp in ((2, 2, 2), (1, 4, 4), (4, 1, 1)):
        c2 = config("nemotron-4-340b", _tp_par(tp))
        o2 = make_optimizer(c2)
        cur, p, st = cur.replan(p, st, mesh={"data": data, "model": model},
                                model=build_model(c2), optimizer=o2)
        out[f"replan/{data}x{model}"] = np.asarray(
            bitwise(state_tensors(cur, p, st), want))
        if tp == 4:
            _, _, _, m = cur.make_train_step(o2)(
                clone(p), clone(st), 2, stream.shard(batch2, cur))
            out["replan/tp4_step"] = np.asarray([float(m["loss"]),
                                                 float(m["grad_norm"])])
            # only globals' schedule changes: the other groups keep their
            # tensors, globals is streamed into its new layout
            r2, p3, s3 = cur.replan(
                p, st, group_schedules={"globals": {"sharded": False}},
                optimizer=o2)
            out["replan/kept"] = np.asarray(sorted(
                g for g in p if p3[g] is p[g]))
            out["replan/kept_state"] = np.asarray(bitwise(
                state_tensors(r2, p3, s3), want))
    _, _, _, m = cur.make_train_step(o2)(p, st, 2, stream.shard(batch2, cur))
    out["replan/resumed"] = np.asarray([float(m["loss"]),
                                        float(m["grad_norm"])])
    return out


def clone(tree):
    """A copy of a state tree (dicts of tensors; a master keeps requiring
    grad)."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(tree.requires_grad)


def json_of(obj) -> str:
    import json

    return json.dumps(obj, sort_keys=True)


def function_inputs(V=96, D=32, B=2, T=8, seed=7):
    """Seeded inputs of the vocab-parallel function checks."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"x": rng.standard_normal((B, T, D)).astype(f32),
            "head": (rng.standard_normal((D, V)) / 4).astype(f32),
            "emb": rng.standard_normal((V, D)).astype(f32),
            "w": rng.standard_normal((B, T, D)).astype(f32),
            "tokens": rng.integers(0, V, (B, T)),
            "labels": rng.integers(0, V, (B, T))}


def vocab_functions(mesh, chunk=16):
    """This rank's vocab part of ``function_inputs`` through ``embed`` +
    ``reduce_out``, ``vocab_parallel_ce`` and ``chunked_ce`` with the TP
    group, forward and backward: the loss values and the gradients of the
    input (whole on every rank) and of this rank's head and table rows."""
    from repro_torch.models import layers as L

    g = mesh.group_for(("model",))
    n, r = dist.get_world_size(g), dist.get_rank(g)
    inp = function_inputs()
    V = inp["head"].shape[1]
    vl, lo = V // n, r * (V // n)
    out = {}
    labels = torch.from_numpy(inp["labels"])
    mask = torch.ones(labels.shape)
    for kind in ("vocab_parallel_ce", "chunked_ce"):
        x = torch.from_numpy(inp["x"]).requires_grad_()
        head = torch.from_numpy(inp["head"][:, lo:lo + vl].copy()) \
            .requires_grad_()
        xin = L.gather_seq(x, g, False)
        if kind == "chunked_ce":
            nll, _ = L.chunked_ce(xin, head, labels, mask, vocab_chunk=chunk,
                                  softcap=30.0, tp_group=g, vocab_start=lo)
        else:
            nll, _ = L.vocab_parallel_ce(L.lm_logits(xin, head,
                                                     softcap=30.0),
                                         labels, mask, tp_group=g,
                                         vocab_start=lo)
        nll.backward()
        out[f"fn/{kind}/loss"] = nll.detach().numpy()
        out[f"fn/{kind}/dx"] = x.grad.numpy()
        out[f"fn/{kind}/dhead"] = head.grad.numpy()
    emb = torch.from_numpy(inp["emb"][lo:lo + vl].copy()).requires_grad_()
    e = L.reduce_out(L.embed(torch.from_numpy(inp["tokens"]), emb, lo), g,
                     False)
    (e * torch.from_numpy(inp["w"])).sum().backward()
    out["fn/embed/out"] = e.detach().numpy()
    out["fn/embed/demb"] = emb.grad.numpy()
    return out


def spawn(world, tmp, runs, **kw):
    """Start ``world`` ranks of ``rank_main`` on ``runs``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    prefix = str(tmp / f"w{world}_")
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, str(tmp / f"store{world}"), prefix,
                               runs), kwargs=kw)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, prefix


def join(procs, prefix, timeout=300):
    """Wait for the ranks (killing stragglers); their ``npz`` files."""
    for p in procs:
        p.join(timeout=timeout)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks {alive} did not finish"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return [dict(np.load(f"{prefix}{r}.npz")) for r in range(len(procs))]


def runs_of(outs, names):
    """{run: {key: value}} from rank 0's file; the metric streams must be
    the same on every rank."""
    res = {}
    for name in names:
        for o in outs[1:]:
            assert np.array_equal(o[f"{name}/metrics"],
                                  outs[0][f"{name}/metrics"]), name
        res[name] = {k.split("/", 1)[1]: v for k, v in outs[0].items()
                     if k.startswith(name + "/")}
    return res


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))



# The reference's runs, in a JAX subprocess with 4 host devices: argv is
# (src dir, out npz, runs JSON {name: [data, model, arch, par, fields,
# schedule]}, steps, seq, batch, lr, init JSON [names whose init_params to
# save first]).  Writes ``name/metrics`` (steps, 2), ``name/<tensor>``
# masters whole (``name/copy_gap/<tensor>``: the largest gap between the
# copies the outer rows hold of an unsplit tensor), ``name/ef/<group>``
# residuals (global; ``ef1``: after the first step) and
# ``init/<name>/<group>`` init_params state leaves (global).  A ninth
# argument, a float other than 0, starts the VLM's gates there.
REF_SCRIPT = r'''
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[1])
from repro.configs import build_model, get_config
from repro.configs.base import ParallelConfig
from repro.core.fsdp import FSDPRuntime
from repro.core.schedule import CommSchedule
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer
out_path, runs = sys.argv[2], json.loads(sys.argv[3])
steps, seq, batch, lr = (int(sys.argv[4]), int(sys.argv[5]),
                         int(sys.argv[6]), float(sys.argv[7]))
init_names = json.loads(sys.argv[8])
gates = float(sys.argv[9]) if len(sys.argv) > 9 else 0.0
if gates:
    _init = FSDPRuntime._init_tensor

    def _gated(spec, seed, layer):
        if spec.name in ("x_gate", "c_gate"):
            return np.full(spec.shape, gates, np.float32)
        return _init(spec, seed, layer)

    FSDPRuntime._init_tensor = staticmethod(_gated)
TP_WIDTHS = dict(n_heads=4, n_kv_heads=2, head_dim=64, d_model=256,
                 d_ff=512, optimizer="adamw")

def config(arch, par, fields):
    cfg = get_config(arch).reduced()
    if arch == "nemotron-4-340b":
        fields = {**TP_WIDTHS, **fields}
    par = {k: tuple(v) if isinstance(v, list) else v for k, v in par.items()}
    return dataclasses.replace(cfg, learning_rate=lr,
                               parallel=ParallelConfig(**par), **fields)

def runtime(data, model, arch, par, fields, sched):
    cfg = config(arch, par, fields)
    mesh = (make_local_mesh(data[1], model, pod=data[0])
            if isinstance(data, list) else make_local_mesh(data, model))
    sched = dict(sched or {})
    groups = sched.pop("group_schedules", None)
    rt = FSDPRuntime(build_model(cfg), mesh,
                     compute_dtype=jnp.float32, donate=False,
                     schedule=CommSchedule(**sched) if sched else None,
                     group_schedules=groups)
    return cfg, rt

def leaves(state):
    return state if isinstance(state, dict) else {"master": state}

out = {}
for name in init_names:
    cfg, rt = runtime(*runs[name])
    for g, st in rt.init_params(0).items():
        for k, v in leaves(st).items():
            out[f"init/{name}/{g}/{k}"] = np.asarray(v)
if init_names:
    np.savez(out_path + ".init.npz", **out)
    os.replace(out_path + ".init.npz", out_path + ".init")
for name, spec in runs.items():
    cfg, rt = runtime(*spec)
    params = rt.init_params(0)
    opt = make_optimizer(cfg)
    state = opt.init(rt)
    fn = rt.make_train_step(opt)
    stream = SyntheticStream(DataConfig(cfg.vocab, seq, batch), cfg)
    step, ms = jnp.int32(0), []
    for i in range(steps):
        params, state, step, m = fn(params, state, step,
                                    stream.shard(stream.batch(i), rt))
        ms.append((float(m["loss"]), float(m["grad_norm"])))
        for g in rt.layouts:
            st = leaves(params[g])
            if i == 0 and steps > 1 and "reduce_ef" in st:
                out[f"{name}/ef1/{g}"] = np.asarray(st["reduce_ef"])
    out[name + "/metrics"] = np.asarray(ms)
    for g, lo in rt.layouts.items():
        st = leaves(params[g])
        if "reduce_ef" in st:
            out[f"{name}/ef/{g}"] = np.asarray(st["reduce_ef"])
        glob = np.asarray(st["master"], np.float32)
        rows = glob.reshape(glob.shape[:-1] + (lo.outer_size, lo.plan.total))
        for s in lo.gdef.specs:
            per = []
            for li in (range(lo.n_layers) if lo.n_layers else [None]):
                row = rows if li is None else rows[li]
                got = [lo.buffer.unpack_np(row[r])[s.name]
                       for r in range(lo.outer_size)]
                sd = lo.gdef.outer.get(s.name)
                if sd is None and lo.outer_size > 1:
                    # the copies the outer rows hold of an unsplit tensor
                    out[f"{name}/copy_gap/{s.name}"] = np.asarray(max(
                        float(np.abs(g - got[0]).max()) for g in got))
                per.append(got[0] if sd is None or lo.outer_size == 1
                           else np.concatenate(got, axis=sd.dim))
            out[f"{name}/{s.name}"] = np.stack(per) if lo.n_layers else per[0]
np.savez(out_path, **out)
'''


def start_reference(src: str, out: str, runs: dict, init=(), steps=STEPS,
                    seq=32, batch=4, gates: float = 0.0):
    """Start the reference's ``runs`` (the ``rank_main`` format) in a JAX
    subprocess; returns the ``Popen``.  ``gates``: where the VLM's gates
    start (0: the reference's init)."""
    import json
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, src, out, json.dumps(runs),
         str(steps), str(seq), str(batch), str(LR), json.dumps(list(init)),
         str(gates)],
        env=env)


# The reference's serve runs and its step-0 checkpoint, in a JAX subprocess
# with 4 host devices: argv is (src dir, out npz, JSON {"serve": {name:
# [data, model, tp, kv, schedule]}, "ckpt0": dir or null}).  Writes
# ``serve/<name>`` the logits (calls, B, 1, V') each call returned, or
# ``err/<name>`` the exception's type and text; with ``ckpt0``, nemotron
# at the ``TP_WIDTHS`` on (2, 2) at tp 2 saved at init with AdamW's state.
REF_EXTRA_SCRIPT = r'''
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[1])
from repro.checkpoint import ckpt
from repro.configs import build_model, get_config
from repro.configs.base import ParallelConfig
from repro.core.fsdp import FSDPRuntime
from repro.core.schedule import CommSchedule
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer
out_path, spec = sys.argv[2], json.loads(sys.argv[3])
B, P, D = %(B)d, %(P)d, %(D)d

def par(tp):
    return ParallelConfig(fsdp_axes=("data",), batch_axes=("data",), tp=tp)

out = {}
for name, (data, model, tp, kv, sched) in spec["serve"].items():
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              n_kv_heads=kv, n_layers=2, parallel=par(tp))
    try:
        m = build_model(cfg)
        rt = FSDPRuntime(m, make_local_mesh(data, model),
                         compute_dtype=jnp.float32, donate=False,
                         schedule=CommSchedule(**sched) if sched else None)
        params = rt.init_params(0)
        rng = np.random.default_rng(11)
        prompt = rng.integers(0, cfg.vocab, (B, P))
        feed = rng.integers(0, cfg.vocab, (B, D))
        cache = m.init_cache(B, P + D + 1)
        logits, cache = rt.make_prefill_step()(
            params, {"tokens": jnp.asarray(prompt, jnp.int32)}, cache)
        got = [np.asarray(logits, np.float32)]
        decode = rt.make_decode_step()
        for i in range(D):
            logits, cache = decode(
                params, {"tokens": jnp.asarray(feed[:, i:i + 1], jnp.int32)},
                cache, jnp.int32(P + i))
            got.append(np.asarray(logits, np.float32))
        out["serve/" + name] = np.stack(got)
    except Exception as e:
        out["err/" + name] = np.asarray(type(e).__name__ + ": " + str(e))
if spec.get("ckpt0"):
    cfg = dataclasses.replace(
        get_config("nemotron-4-340b").reduced(), learning_rate=%(LR)r,
        n_heads=4, n_kv_heads=2, head_dim=64, d_model=256, d_ff=512,
        optimizer="adamw", parallel=par(2))
    rt = FSDPRuntime(build_model(cfg), make_local_mesh(2, 2),
                     compute_dtype=jnp.float32, donate=False)
    ckpt.save(spec["ckpt0"], rt, rt.init_params(0),
              make_optimizer(cfg).init(rt), step=0)
np.savez(out_path, **out)
''' % {"B": SERVE_B, "P": SERVE_P, "D": SERVE_DECODES, "LR": LR}


def start_reference_extra(src: str, out: str, serve: dict, ckpt0=None):
    """Start ``REF_EXTRA_SCRIPT`` in a JAX subprocess; returns the
    ``Popen``."""
    import json
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", REF_EXTRA_SCRIPT, src, out,
         json.dumps({"serve": serve, "ckpt0": ckpt0})], env=env)
