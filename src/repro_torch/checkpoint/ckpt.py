"""Communication-free sharded checkpointing over RaggedShard buffers (port
of ``repro/checkpoint/ckpt.py``, the paper's section 4).

Each group's flat buffer is saved beside its plan's ``checkpoint_index``
(name -> shape, dtype, granularity, offset).  A save writes only local
shards, with no collective; a load restores onto another world size, plan,
planner or store format by streaming tensors through the per-tensor shard
index (``core.reshard``).

Format v2 (written here, byte for byte the reference's; v1 loads too):

  * ``meta.json`` -- ``{"version": 2, "step", "groups": {...}, "opt":
    [...]}``: per group the checkpoint index, the layout fields
    (``shard_size``, ``num_shards``, ``outer_size``, ``outer_dims``,
    ``n_layers``, ``mode``) and the store fields (``store``,
    ``quant_block``, ``ef_m``); ``opt`` is the optimizer leaf manifest.
  * ``plan.json`` -- the resolved ``ShardingPlan`` (``load_plan``).
  * ``shards/`` -- one ``.npy`` per (group, leaf, shard):
    ``p__<group>__<leaf>__<j>.npy`` holds shard ``j`` of that leaf,
    shaped ``(n_layers, S_leaf)`` or ``(S_leaf,)``; a bare fp32 or bf16
    state is the leaf ``master``.  Optimizer leaves are
    ``o__<i>__<j>.npy`` (buffer-shaped: moments, 8-bit codes and scales)
    or ``o__<i>.npy`` (Shampoo's factors, stored unpadded so they do not
    depend on the plan), numbered in the reference's flatten order (keys
    sorted at each level) under the reference's key paths.  bfloat16 and
    float8 leaves are widened to float32 on disk (exact), and the
    manifest's ``dtype`` names the leaf's own dtype (``bfloat16``,
    ``float8_e4m3fn``, ...).

A group's buffer is ``outer_size * num_shards`` uniform rows; rank (d, r)
of a group split over the model axis holds row ``j = r * m + k``: FSDP
shard ``k`` of outer part ``r`` (the reference's order).  Each rank writes
its own row when it is the first of the ranks that hold it (index 0 on
every mesh axis the group is neither sharded nor split over: one copy of
a ``layers_rep`` row, of an unsharded group, of an HSDP pod replica); a
dense leaf is written by rank 0; rank 0 writes ``meta.json`` and
``plan.json``, and a barrier ends ``save``.  ``load`` reads this rank's
row, or streams its extents through ``GroupIndex``, so a checkpoint of W
ranks restores on W', across TP degrees (a tensor moving between
``layers`` and ``layers_rep`` among them).

PARITY: same plan -- BITWISE per leaf; another plan, planner or TP degree
-- BITWISE on the master and the AdamW moments (8-bit Adam's block-granular
state raises on an outer-layout change, as the reference's does); another
store format or quant block -- the master exact,
its codes requantized from it (``ParamStore.create``: ``ops.quantize``,
the kernel on a card) and the residual restarted at zero, the classes of
the reference's ``load``.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch
import torch.distributed as dist

from ..core.ragged import checkpoint_index
from ..core.reshard import (GroupIndex, copy_tensor, row_writer,
                            stream_tensors)
from ..quant.fp8 import FP8_DTYPES, fp8_encode

_FP8_FMT = {dt: name for name, dt in FP8_DTYPES.items()}
_NP = {torch.float32: np.float32, torch.int8: np.int8}


# --------------------------------------------------------------------------- #
# dtypes: .npy holds numpy's own dtypes only
# --------------------------------------------------------------------------- #

def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype by the reference's numpy name (``float32``,
    ``bfloat16``, ``float8_e4m3fn``, ...)."""
    return str(dtype).split(".")[-1]


def _savable(t: torch.Tensor) -> np.ndarray:
    """A leaf as a host array numpy can save: bfloat16 and float8 widened
    to float32 (exact)."""
    t = t.detach()
    if t.dtype not in _NP:
        t = t.float()
    return t.cpu().numpy()


def _narrow(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Undo ``_savable``: a host array as a CPU tensor of ``dtype`` (float8
    through ``fp8_encode``, never a library cast: every widened code
    re-encodes to itself)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == dtype:
        return t
    if dtype in _FP8_FMT:
        return fp8_encode(t.float(), _FP8_FMT[dtype])
    return t.to(dtype)


# --------------------------------------------------------------------------- #
# shard files
# --------------------------------------------------------------------------- #

def param_shard_file(group: str, leaf: str, j: int) -> str:
    return f"p__{group}__{leaf}__{j}.npy"


def opt_shard_file(file: str, j: int) -> str:
    return f"{file}__{j}.npy"


def shard_file_reader(shards_dir, name_of_j):
    """A ``core.reshard`` reader over per-shard ``.npy`` files, memmapped,
    so assembling one tensor touches only that tensor's extents."""
    shards_dir = pathlib.Path(shards_dir)
    cache: dict[int, np.ndarray] = {}

    def read(j: int, layer):
        mm = cache.get(j)
        if mm is None:
            f = shards_dir / name_of_j(j)
            if not f.exists():
                raise ValueError(f"checkpoint shard file missing: {f}")
            mm = cache[j] = np.load(f, mmap_mode="r")
        return mm if layer is None else mm[layer]

    return read


def group_master_reader(shards_dir, group: str):
    """Reader over a group's (fp32-widened) master shards: every store
    saves a ``master`` leaf."""
    return shard_file_reader(
        shards_dir, lambda j: param_shard_file(group, "master", j))


def _own_row(runtime, lo) -> int:
    """The shard row this rank saves and loads of group ``lo``: its block
    index, ``r * m + k`` (outer part, FSDP shard)."""
    return runtime._block_index(lo)


def _barrier(runtime) -> None:
    if dist.get_world_size(runtime.group) > 1:
        dist.barrier(group=runtime.group)


# --------------------------------------------------------------------------- #
# save (format v2)
# --------------------------------------------------------------------------- #

def group_meta(lo) -> dict:
    """One group's ``meta.json`` entry (the reference's fields, in its
    order)."""
    return {
        "index": checkpoint_index(lo.plan),
        "shard_size": lo.plan.shard_size,
        "num_shards": lo.plan.num_shards,
        "outer_size": lo.outer_size,
        "outer_dims": {n: sd.dim for n, sd in lo.gdef.outer.items()},
        "n_layers": lo.n_layers,
        "mode": lo.plan.mode,
        "store": lo.store.fmt,
        "quant_block": lo.store.block,
        # the q8 reduce wire's residual chunks (0: none); saved with the
        # weights, so the error-feedback history survives a restart
        "ef_m": lo.store.ef_m,
    }


def _as_leaves(state) -> dict:
    """A store state as ``{leaf: tensor}`` (a bare buffer is ``master``)."""
    return dict(state) if isinstance(state, dict) else {"master": state}


def _classify_opt_leaf(runtime, keys: tuple[str, ...],
                       shape: tuple[int, ...]):
    """(kind, group, div) of one optimizer leaf of global ``shape``:
    ``buffer`` -- shaped like a group's buffer with the last dim divided by
    ``div`` (moments; 8-bit codes at div 1, their scales at the quant
    block), resharded through the extent map; ``factor`` -- Shampoo's
    per-layer factors keyed ``<group>/<tensor>/...`` over the group's
    padded layer dim, plan-independent once unpadded; ``dense`` --
    anything else, saved whole."""
    shape = tuple(shape)
    last = keys[-1]
    lo = runtime.layouts.get(last)
    if lo is not None and shape:
        gs = lo.global_shape()
        if (shape[:-1] == tuple(gs[:-1])
                and shape[-1] and gs[-1] % shape[-1] == 0):
            return "buffer", last, gs[-1] // shape[-1]
    if "/" in last:
        g = last.split("/", 1)[0]
        lo = runtime.layouts.get(g)
        if (lo is not None and lo.n_layers and len(shape) >= 1
                and shape[0] >= lo.n_layers):
            return "factor", g, None
    return "dense", None, None


def _opt_layout(runtime, opt_state):
    """The config's optimizer state layout ``{key: {leaf: (dtype, global
    shape, sharded axis)}}``, checked against ``opt_state``'s keys."""
    from ..optim import make_optimizer

    layout = make_optimizer(runtime.cfg).state_layout(runtime)
    if set(opt_state) != set(layout) or any(
            set(opt_state[k]) != set(layout[k]) for k in layout):
        raise ValueError(
            f"optimizer state keys {sorted(opt_state)} do not match the "
            f"{runtime.cfg.optimizer} state's {sorted(layout)}")
    return layout


def _flat_opt(layout):
    """``((key, leaf), (dtype, shape, axis))`` in the reference's flatten
    order: dict keys sorted at each level."""
    return [((k, leaf), layout[k][leaf])
            for k in sorted(layout) for leaf in sorted(layout[k])]


def _save_factor(runtime, f: pathlib.Path, t: torch.Tensor, axis, L: int,
                 key: str):
    """Shampoo factor ``key``'s ``t`` (this rank's rows of the padded
    ``(Lp, k, k)`` stack, or the whole of it) saved unpadded as ``(L, k,
    k)``: each rank of its group's FSDP axes writes its own rows into one
    memmapped file, the first of the ranks that hold them (index 0 on the
    model and pod axes it is replicated over)."""
    a = _savable(t)
    blocks, idx = runtime.leaf_share(key) if axis is not None else (1, 0)
    if blocks == 1:
        if runtime.rank == 0:
            np.save(f, a[:L])
        return
    if runtime.rank == 0:
        np.lib.format.open_memmap(f, mode="w+", dtype=a.dtype,
                                  shape=(L,) + a.shape[1:]).flush()
    _barrier(runtime)
    fsdp = runtime.layouts[key.split("/", 1)[0]].fsdp_axes
    coords = runtime.mesh.coords
    lo_row = idx * a.shape[0]
    n = min(a.shape[0], L - lo_row)
    if n > 0 and not any(coords[ax] for ax in coords if ax not in fsdp):
        mm = np.load(f, mmap_mode="r+")
        mm[lo_row:lo_row + n] = a[:n]
        mm.flush()
        del mm


def save(path, runtime, params, opt_state=None, step: int = 0) -> None:
    """Write ``params`` (and ``opt_state``) of ``runtime`` at ``step`` as a
    format v2 checkpoint under ``path``; every rank of the runtime's group
    calls it."""
    path = pathlib.Path(path)
    shards = path / "shards"
    shards.mkdir(parents=True, exist_ok=True)
    meta = {
        "version": 2,
        "step": int(step),
        "groups": {name: group_meta(lo)
                   for name, lo in runtime.layouts.items()},
    }
    for name, lo in runtime.layouts.items():
        if not runtime._owns_block(lo):
            continue
        j = _own_row(runtime, lo)
        for leaf, t in _as_leaves(params[name]).items():
            np.save(shards / param_shard_file(name, leaf, j), _savable(t))
    manifest = []
    if opt_state is not None:
        layout = _opt_layout(runtime, opt_state)
        for i, (keys, (dtype, shape, axis)) in enumerate(_flat_opt(layout)):
            t = opt_state[keys[0]][keys[1]]
            kind, g, div = _classify_opt_leaf(runtime, keys, shape)
            ent = {"path": list(keys), "kind": kind,
                   "dtype": _dtype_name(t.dtype), "file": f"o__{i:03d}"}
            if kind == "buffer":
                lo = runtime.layouts[g]
                ent.update(group=g, div=div)
                if runtime._owns_block(lo):
                    np.save(shards / opt_shard_file(
                        ent["file"], _own_row(runtime, lo)), _savable(t))
            elif kind == "factor":
                lo = runtime.layouts[g]
                ent.update(group=g, n_layers=lo.n_layers)
                _save_factor(runtime, shards / f"{ent['file']}.npy", t,
                             axis, lo.n_layers, keys[1])
            else:
                if axis is not None:
                    raise NotImplementedError(
                        f"optimizer leaf {'/'.join(keys)}: a sharded leaf "
                        f"of no group's shape has no checkpoint layout")
                if runtime.rank == 0:
                    np.save(shards / f"{ent['file']}.npy", _savable(t))
            manifest.append(ent)
    meta["opt"] = manifest
    if runtime.rank == 0:
        (path / "meta.json").write_text(json.dumps(meta, indent=1))
        # the resolved plan, for load_plan and exact restores
        (path / "plan.json").write_text(
            json.dumps(runtime.plan.to_json(), sort_keys=True, indent=1))
    _barrier(runtime)


# --------------------------------------------------------------------------- #
# load (v2 streaming; v1 below)
# --------------------------------------------------------------------------- #

def _same_layout(saved: dict, lo) -> bool:
    """Shard bytes are reusable iff every layout field and the whole
    placement index match."""
    return (saved["shard_size"] == lo.plan.shard_size
            and saved["num_shards"] == lo.plan.num_shards
            and saved.get("outer_size", 1) == lo.outer_size
            and {k: int(v) for k, v in saved.get("outer_dims", {}).items()}
            == {n: sd.dim for n, sd in lo.gdef.outer.items()}
            and saved.get("n_layers", 0) == lo.n_layers
            and saved.get("mode", "ragged") == lo.plan.mode
            and saved["index"] == checkpoint_index(lo.plan))


def _same_store(saved: dict, lo) -> bool:
    saved_store = saved.get("store", "fp32")
    return (saved_store == lo.store.fmt
            and saved.get("ef_m", 0) == lo.store.ef_m
            and (not (lo.store.quantized or lo.store.has_ef)
                 or saved.get("quant_block") == lo.store.block))


def _same_layout_idx(a: GroupIndex, b: GroupIndex) -> bool:
    return (a.plan.shard_size == b.plan.shard_size
            and a.plan.num_shards == b.plan.num_shards
            and a.outer_size == b.outer_size
            and dict(a.outer_dims) == dict(b.outer_dims)
            and (a.n_layers or 0) == (b.n_layers or 0)
            and a.plan.mode == b.plan.mode
            and checkpoint_index(a.plan) == checkpoint_index(b.plan))


def _local_shape(runtime, lo, div: int = 1) -> tuple[int, ...]:
    """A rank's block of group ``lo``: one of its ``outer_size *
    num_shards`` rows (the whole buffer of an unsharded, unsplit group)."""
    shape = lo.local_shape()
    return shape[:-1] + (shape[-1] // div,)


def _to_device(runtime, t: torch.Tensor, requires_grad: bool = False):
    return t.to(runtime.device).requires_grad_(requires_grad)


def _state_of(runtime, lo, leaves: dict[str, torch.Tensor]):
    """A store state from its CPU leaves, on the device (the master
    requires grad)."""
    placed = {k: _to_device(runtime, v, k == "master")
              for k, v in leaves.items()}
    if lo.store.state_keys() is None:
        return placed["master"]
    return {k: placed[k] for k in lo.store.state_keys()}


def load(path, runtime, opt_state_like=None):
    """Restore this rank's params (and optimizer state) from checkpoint
    ``path``: ``(params, step)``, or ``(params, step, opt_state)`` when
    ``opt_state_like`` (a state of the config's optimizer, e.g.
    ``optimizer.init(runtime)``, whose keys are checked) is given.

    A group whose saved layout and store match the runtime's reads its own
    shard files back bitwise (codes and residual included).  Any other
    group streams the fp32 master tensor by tensor through the saved and
    live shard indices -- any world size, planner or store format -- into
    this rank's row, and its store rebuilds the rest from it (codes
    requantized, the residual zero).  Optimizer buffers follow their
    tensors' extents the same way (block-granular 8-bit state on the
    aligned path), Shampoo's factors are re-padded to the plan."""
    path = pathlib.Path(path)
    meta = json.loads((path / "meta.json").read_text())
    if int(meta.get("version", 1)) < 2:
        return _load_legacy(path, meta, runtime, opt_state_like)
    shards = path / "shards"
    saved_groups = meta["groups"]
    src_idx = {g: GroupIndex.from_meta(sg) for g, sg in saved_groups.items()}
    tensor_src = {t: g for g, sg in saved_groups.items() for t in sg["index"]}

    params = {}
    for name, lo in runtime.layouts.items():
        saved = saved_groups.get(name)
        own = _own_row(runtime, lo)
        if saved is not None and _same_layout(saved, lo) \
                and _same_store(saved, lo):
            leaves = {
                leaf: _narrow(np.load(shards / param_shard_file(
                    name, leaf, own)), lo.store.leaf_dtype(leaf))
                for leaf in (lo.store.state_keys() or ("master",))}
            params[name] = _state_of(runtime, lo, leaves)
            continue
        dst_idx = GroupIndex.from_layout(lo)
        master = np.zeros(_local_shape(runtime, lo), np.float32)

        def lookup(tname, name=name):
            g = tensor_src.get(tname)
            if g is None:
                raise ValueError(
                    f"tensor {tname!r} (group {name!r}) not in checkpoint "
                    f"{path}")
            return src_idx[g], group_master_reader(shards, g)

        stream_tensors(dst_idx, row_writer(master, own), lookup)
        # another plan or format: the store rebuilds from the master (the
        # residual restarts at zero)
        params[name] = lo.store.create(_to_device(
            runtime, torch.from_numpy(master), True))
    out = [params, int(meta["step"])]
    if opt_state_like is not None:
        out.append(_load_opt(shards, meta, runtime, opt_state_like, src_idx,
                             tensor_src))
    return tuple(out)


def _load_opt(shards, meta, runtime, opt_state_like, src_idx, tensor_src):
    man = {tuple(e["path"]): e for e in meta.get("opt", [])}
    layout = _opt_layout(runtime, opt_state_like)
    out: dict[str, dict[str, torch.Tensor]] = {k: {} for k in layout}
    for keys, (dtype, shape, axis) in _flat_opt(layout):
        a = _restore_opt_leaf(shards, man, keys, dtype, shape, axis,
                              runtime, src_idx, tensor_src)
        out[keys[0]][keys[1]] = _to_device(runtime, _narrow(a, dtype))
    return out


def _block(runtime, lo, a: np.ndarray) -> np.ndarray:
    """This rank's block of a group's global array ``a`` (its last axis in
    ``outer_size * num_shards`` rows)."""
    n = a.shape[-1] // (lo.outer_size * lo.plan.num_shards)
    j = _own_row(runtime, lo)
    return a[..., j * n:(j + 1) * n]


def _share(runtime, a: np.ndarray, axis, name: str) -> np.ndarray:
    """This rank's share of leaf ``name``'s global ``a`` along ``axis``
    (``FSDPRuntime.leaf_share``; all of it for None)."""
    if axis is None:
        return a
    blocks, i = runtime.leaf_share(name)
    n = a.shape[axis] // blocks
    return np.take(a, range(i * n, (i + 1) * n), axis=axis)


def _restore_opt_leaf(shards, man, keys, dtype, shape, axis, runtime,
                      src_idx, tensor_src) -> np.ndarray:
    pathname = "/".join(keys)
    kind, g_new, div = _classify_opt_leaf(runtime, keys, shape)
    ent = man.get(keys)
    if kind != "buffer":
        if ent is None:
            raise ValueError(
                f"optimizer state leaf {pathname!r} not in checkpoint "
                f"(saved leaves: {sorted('/'.join(p) for p in man)})")
        a = np.load(shards / f"{ent['file']}.npy")
        if kind == "factor":
            L = runtime.layouts[g_new].n_layers
            if a.shape[1:] != tuple(shape[1:]) or a.shape[0] < L:
                raise ValueError(
                    f"optimizer state {pathname!r}: saved factor shape "
                    f"{a.shape} incompatible with {tuple(shape)}")
            out = np.zeros(shape, a.dtype)
            out[:L] = a[:L]
            a = out
        elif tuple(a.shape) != tuple(shape):
            raise ValueError(
                f"optimizer state {pathname!r}: saved shape {a.shape} != "
                f"expected {tuple(shape)}")
        return _share(runtime, a, axis, keys[1])

    lo = runtime.layouts[g_new]
    own = _own_row(runtime, lo)
    dst_idx = GroupIndex.from_layout(lo)
    if ent is not None and ent["kind"] == "buffer" \
            and ent.get("div") == div \
            and g_new in src_idx and _same_layout_idx(src_idx[g_new], dst_idx):
        return np.load(shards / opt_shard_file(ent["file"], own))

    # another plan: each tensor's slice of the buffer follows the
    # parameter's extents from its saved owning group
    dest = None
    for name in lo.plan.names:
        g_old = tensor_src.get(name)
        if g_old is None:
            raise ValueError(
                f"optimizer state {pathname!r}: tensor {name!r} not in "
                f"checkpoint")
        src_ent = man.get(keys[:-1] + (g_old,))
        if src_ent is None or src_ent["kind"] != "buffer":
            raise ValueError(
                f"optimizer state {pathname!r}: no saved buffer leaf for "
                f"source group {g_old!r} "
                f"(expected path {'/'.join(keys[:-1] + (g_old,))!r})")
        if src_ent.get("div") != div:
            raise ValueError(
                f"optimizer state {pathname!r}: block granularity changed "
                f"({src_ent.get('div')} -> {div}, e.g. a quant_block "
                f"change); 8-bit optimizer state cannot be resharded "
                f"across it -- reinitialize the optimizer instead")
        read = shard_file_reader(
            shards, lambda j, f=src_ent["file"]: opt_shard_file(f, j))
        if dest is None:
            probe = np.asarray(read(0, 0 if lo.n_layers else None))
            dest = np.zeros(_local_shape(runtime, lo, div), probe.dtype)
        s_idx = src_idx[g_old]
        if (s_idx.n_layers or 0) != (lo.n_layers or 0):
            raise ValueError(
                f"optimizer state {pathname!r}: layer count changed for "
                f"{name!r} ({s_idx.n_layers} -> {lo.n_layers})")
        aligned = div > 1 or dest.dtype.kind in "iu"
        write = row_writer(dest, own)
        for li in (range(lo.n_layers) if lo.n_layers else [None]):
            copy_tensor(s_idx, dst_idx, name, read, write,
                        layer=li, div=div, aligned=aligned)
    return dest


def load_plan(path):
    """The ShardingPlan saved with a checkpoint (None for a checkpoint
    without one).  ``FSDPRuntime(model, group, plan=load_plan(p))``
    rebuilds the saved layout exactly, so every group takes the bitwise
    restore; ``plan.diff`` against a fresh plan shows which groups would
    be rebuilt from the master instead."""
    from ..core.policy import ShardingPlan

    f = pathlib.Path(path) / "plan.json"
    if not f.exists():
        return None
    return ShardingPlan.from_json(json.loads(f.read_text()))


# --------------------------------------------------------------------------- #
# format v1 (one state.npz of global arrays) -- read only
# --------------------------------------------------------------------------- #

def _host_leaf(a, dtype: torch.dtype) -> torch.Tensor:
    """A v1 array (any float dtype numpy or ml_dtypes holds) as a CPU
    tensor of ``dtype``."""
    a = np.asarray(a)
    if a.dtype.name == _dtype_name(dtype):
        if dtype in _NP:
            return torch.from_numpy(np.ascontiguousarray(a))
        raw = np.uint16 if dtype == torch.bfloat16 else np.uint8
        return torch.from_numpy(
            np.ascontiguousarray(a).view(raw).copy()).view(dtype)
    if a.dtype.kind in "iu":
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return _narrow(np.asarray(a, np.float32), dtype)


def _load_legacy(path, meta, runtime, opt_state_like):
    data = np.load(path / "state.npz")
    params = {}
    any_cross_plan = None
    for name, lo in runtime.layouts.items():
        saved = meta["groups"][name]
        saved_store = saved.get("store", "fp32")
        same_plan = (
            saved["shard_size"] == lo.plan.shard_size
            and saved["num_shards"] == lo.plan.num_shards
            and saved.get("outer_size", 1) == lo.outer_size
            and saved.get("mode", "ragged") == lo.plan.mode
        )
        keys = lo.store.state_keys()
        if same_plan and _same_store(saved, lo):
            arrays = ({leaf: data[f"param__{name}__{leaf}"] for leaf in keys}
                      if keys is not None
                      else {"master": data[f"param__{name}"]})
            leaves = {
                leaf: _host_leaf(_block(runtime, lo, a),
                                 lo.store.leaf_dtype(leaf) if keys
                                 else lo.store.storage_dtype)
                for leaf, a in arrays.items()}
            params[name] = _state_of(runtime, lo, leaves)
            continue
        if not same_plan:
            any_cross_plan = name
        master = _saved_master(data, name, saved_store, saved.get("ef_m", 0))
        if not same_plan:
            master = _repack(master, saved, lo)
        params[name] = lo.store.create(_to_device(
            runtime, torch.from_numpy(np.ascontiguousarray(
                _block(runtime, lo, master))), True))
    out = [params, int(meta["step"])]
    if opt_state_like is not None:
        if any_cross_plan is not None:
            raise ValueError(
                f"legacy (v1) checkpoint: group {any_cross_plan!r} was "
                f"saved under a different plan; v1 optimizer state is "
                f"same-plan only.  Re-save under format v2 or load without "
                f"opt_state_like")
        layout = _opt_layout(runtime, opt_state_like)
        opt: dict[str, dict[str, torch.Tensor]] = {k: {} for k in layout}
        for keys, (dtype, shape, axis) in _flat_opt(layout):
            key = "opt__" + "__".join(keys)
            if key not in data:
                raise ValueError(
                    f"optimizer state leaf {key!r} not in legacy "
                    f"checkpoint {path}")
            lo = runtime.layouts.get(keys[1])
            a = (_block(runtime, lo, data[key])
                 if lo is not None and axis is not None
                 else _share(runtime, data[key], axis, keys[1]))
            opt[keys[0]][keys[1]] = _to_device(runtime, _host_leaf(a, dtype))
        out.append(opt)
    return tuple(out)


def _saved_master(data, name: str, saved_store: str,
                  saved_ef_m: int = 0) -> np.ndarray:
    """A group's fp32 master from a v1 state of any format (dict states
    save a ``master`` leaf)."""
    if saved_store == "q8_block" or saved_ef_m:
        return np.asarray(data[f"param__{name}__master"], np.float32)
    return np.asarray(data[f"param__{name}"], np.float32)


def _repack(buf: np.ndarray, saved: dict, lo) -> np.ndarray:
    """v1 cross-plan restore: unpack the tensors through the saved index
    and pack them under the current plan."""
    if saved.get("outer_size", 1) != lo.outer_size:
        raise ValueError(
            f"legacy cross-TP restore not supported: checkpoint outer_size "
            f"{saved.get('outer_size', 1)} != runtime {lo.outer_size}; "
            f"re-save under format v2")
    idx = saved["index"]
    old_total = saved["shard_size"] * saved["num_shards"]
    layers = buf.reshape((-1, old_total))
    out = np.zeros((layers.shape[0], lo.plan.total), buf.dtype)
    for li in range(layers.shape[0]):
        old = layers[li]
        arrays = {
            name: old[m["offset"]: m["offset"] + int(np.prod(m["shape"]))
                      ].reshape(m["shape"])
            for name, m in idx.items()
        }
        out[li] = lo.buffer.pack(arrays)
    return out if buf.ndim > 1 else out[0]
