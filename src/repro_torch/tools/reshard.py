"""Offline checkpoint resharding: rewrite a format v2 checkpoint for a new
plan, file to file (port of ``tools/reshard.py``).

    PYTHONPATH=src python -m repro_torch.tools.reshard SRC DST \\
        --arch gemma2-2b [--reduced | --full] [--layers L] --data N \\
        [--model M] [--tp N] [--planner ragged] [--policies auto] \\
        [--optimizer NAME] [--drop-opt] [--device cuda|cpu]

The destination layout is a ``ShardingPlan`` resolved on the host
(``core.policy.plan`` needs no devices), so a checkpoint of 8 ranks can be
rewritten for 2 -- or for another TP degree (``--tp``, on a model axis of
``--model`` ranks), planner, store format or quant block -- on any
machine.  Both sides are per-shard ``.npy`` files addressed through
the per-tensor shard index (``core.reshard``) and memmapped, so peak host
memory is one tensor and one shard row.  A group whose layout and store
are unchanged is copied byte for byte; a changed group streams its master
tensor by tensor, then derives its store's leaves shard row by shard row:
the bf16 rounding, the fp8 codes (``quant.fp8.fp8_encode``) or the q8
codes and scales (``kernels.ops.quantize``: the plain version on the CPU,
the kernel on the card), each what a save under the new plan would write;
a residual restarts at zero.  Across TP degrees a tensor split on its
leading dim (the vocab-parallel embedding) or not split at all moves
extent to extent; one split on a later dim is read whole from its outer
parts and split anew.  A tensor may change groups (``wk``/``wv`` between
``layers`` and ``layers_rep`` where tp passes the KV head count).

Optimizer state follows: buffer families follow their tensors' extents
(8-bit codes and scales on the aligned path), Shampoo's unpadded factors
and dense leaves are copied; 8-bit Adam's block-granular state raises on
an outer-layout change.  ``--drop-opt`` leaves it out (the resumed run
starts its optimizer afresh).

The tool runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import shutil

import numpy as np
import torch

from ..checkpoint.ckpt import (opt_shard_file, param_shard_file,
                               shard_file_reader)
from ..core.ragged import checkpoint_index
from ..core.reshard import GroupIndex, copy_tensor
from ..core.store import EF_KEY
from ..kernels import ops
from ..quant.fp8 import fp8_encode


def _entry_meta(entry) -> dict:
    """The destination ``meta.json`` entry of a plan entry (the
    ``ckpt.group_meta`` fields, from the plan instead of a runtime)."""
    return {
        "index": checkpoint_index(entry.plan),
        "shard_size": entry.plan.shard_size,
        "num_shards": entry.plan.num_shards,
        "outer_size": entry.outer_size,
        "outer_dims": {k: int(v) for k, v in entry.outer_dims.items()},
        "n_layers": entry.n_layers,
        "mode": entry.plan.mode,
        "store": entry.store.fmt,
        "quant_block": entry.store.block,
        "ef_m": entry.store.ef_m,
    }


def _same_group(saved: dict, want: dict) -> bool:
    """Byte-copy eligibility: every layout and store field matches."""
    keys = ("index", "shard_size", "num_shards", "outer_size", "outer_dims",
            "n_layers", "mode", "store", "ef_m")
    if any(saved.get(k) != want[k] for k in keys):
        return False
    if want["store"] == "q8_block" or want["ef_m"]:
        return saved.get("quant_block") == want["quant_block"]
    return True


def _same_layout_fields(saved: dict, want: dict) -> bool:
    keys = ("index", "shard_size", "num_shards", "outer_size", "outer_dims",
            "n_layers", "mode")
    return all(saved.get(k) == want[k] for k in keys)


def _open_rows(path, n_layers: int, row_len: int, dtype):
    """A zero-filled destination ``.npy`` memmap shaped like one shard
    file."""
    shape = (n_layers, row_len) if n_layers else (row_len,)
    return np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                     shape=shape)


def _rows_writer(mmaps):
    def write(j: int, layer):
        return mmaps[j] if layer is None else mmaps[j][layer]

    return write


def _reshard_group_params(gname, entry, src_shards, dst_shards, tensor_src,
                          src_idx, device):
    """Stream one changed group's master, then derive its store's
    leaves."""
    dst = GroupIndex.from_entry(entry)
    store = entry.store
    S, L = entry.plan.shard_size, entry.n_layers or 0
    masters = {j: _open_rows(dst_shards / param_shard_file(gname, "master", j),
                             L, S, np.float32)
               for j in range(dst.num_rows)}
    write = _rows_writer(masters)
    for name in entry.plan.names:
        g_old = tensor_src.get(name)
        if g_old is None:
            raise ValueError(
                f"tensor {name!r} (group {gname!r}) not in source "
                f"checkpoint")
        s_idx = src_idx[g_old]
        if (s_idx.n_layers or 0) != L:
            raise ValueError(
                f"{name}: layer count changed ({s_idx.n_layers} -> {L})")
        read = shard_file_reader(
            src_shards, lambda j, g=g_old: param_shard_file(g, "master", j))
        for li in (range(L) if L else [None]):
            copy_tensor(s_idx, dst, name, read, write, layer=li)
    # the store's other leaves, shard row by shard row (S is a multiple of
    # the quant block, so per-row quantization equals the whole buffer's)
    extra = {}
    leaves = [k for k in (store.state_keys() or ()) if k in ("codes",
                                                              "scales")]
    for leaf in leaves:
        for j in range(dst.num_rows):
            n = S // store.block if leaf == "scales" else S
            extra[leaf, j] = _open_rows(
                dst_shards / param_shard_file(gname, leaf, j), L, n,
                np.int8 if store.quantized and leaf == "codes"
                else np.float32)
    for j, mm in masters.items():
        rows = mm if L else mm[None, :]
        for li in range(rows.shape[0]):
            if store.fmt == "bf16":
                rows[li] = torch.from_numpy(rows[li]).to(
                    torch.bfloat16).float().numpy()
                continue
            if not (store.quantized or store.fp8):
                continue
            x = torch.from_numpy(np.array(rows[li])).to(device)
            if store.fp8:
                out = {"codes": fp8_encode(x, store.fmt).float()}
            else:
                codes, scales = ops.quantize(x, store.block)
                out = {"codes": codes, "scales": scales}
            for leaf, t in out.items():
                dst_mm = extra[leaf, j]
                (dst_mm[li] if L else dst_mm)[...] = t.cpu().numpy()
    if store.has_ef:
        for j in range(dst.num_rows):
            # a fresh memmap is zero-filled: a reset error-feedback history
            _open_rows(dst_shards / param_shard_file(gname, EF_KEY, j),
                       L, S * store.ef_m, np.float32).flush()
    for mm in list(masters.values()) + list(extra.values()):
        mm.flush()


def _tensor_group_map(plan) -> dict:
    return {t: g for g, e in plan.groups.items() for t in e.plan.names}


def reshard(src, dst, new_plan, *, drop_opt: bool = False,
            verbose: bool = True, device="cuda") -> dict:
    """Rewrite checkpoint ``src`` into ``dst`` under ``new_plan``; returns
    which groups were copied and which streamed, and what became of the
    optimizer state.  ``device``: where the q8 requantization runs."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "reshard requantizes on the card by default and no CUDA device "
            "is available; pass device='cpu' (--device cpu)")
    src, dst = pathlib.Path(src), pathlib.Path(dst)
    meta_src = json.loads((src / "meta.json").read_text())
    if int(meta_src.get("version", 1)) < 2:
        raise ValueError(
            f"{src}: legacy (v1) checkpoint; load and re-save it under the "
            f"current format first (ckpt.load, ckpt.save), then reshard")
    src_shards, dst_shards = src / "shards", dst / "shards"
    dst_shards.mkdir(parents=True, exist_ok=True)

    sgroups = meta_src["groups"]
    src_idx = {g: GroupIndex.from_meta(sg) for g, sg in sgroups.items()}
    tensor_src = {t: g for g, sg in sgroups.items() for t in sg["index"]}

    summary = {"copied": [], "streamed": [],
               "opt": "dropped" if drop_opt else "resharded"}
    dst_groups = {}
    for gname, entry in new_plan.groups.items():
        want = _entry_meta(entry)
        dst_groups[gname] = want
        saved = sgroups.get(gname)
        if saved is not None and _same_group(saved, want):
            rows = entry.outer_size * entry.plan.num_shards
            for leaf in (entry.store.state_keys() or ("master",)):
                for j in range(rows):
                    f = param_shard_file(gname, leaf, j)
                    shutil.copyfile(src_shards / f, dst_shards / f)
            summary["copied"].append(gname)
        else:
            _reshard_group_params(gname, entry, src_shards, dst_shards,
                                  tensor_src, src_idx, device)
            summary["streamed"].append(gname)
        if verbose:
            how = "copy" if gname in summary["copied"] else "stream"
            print(f"[reshard] params {gname}: {how}")

    manifest = []
    if not drop_opt:
        manifest = _reshard_opt(meta_src, new_plan, src_shards, dst_shards,
                                tensor_src, src_idx, verbose)

    meta = {"version": 2, "step": int(meta_src["step"]),
            "groups": dst_groups, "opt": manifest}
    (dst / "meta.json").write_text(json.dumps(meta, indent=1))
    (dst / "plan.json").write_text(
        json.dumps(new_plan.to_json(), sort_keys=True, indent=1))
    return summary


def _reshard_opt(meta_src, new_plan, src_shards, dst_shards, tensor_src,
                 src_idx, verbose):
    """Move the optimizer manifest: buffer families re-follow their
    tensors under the new plan; factors and dense leaves are copied (a
    factor follows its tensor's new owning group)."""
    families: dict[tuple, dict] = {}
    others = []
    for ent in meta_src.get("opt", []):
        if ent["kind"] == "buffer":
            families.setdefault(tuple(ent["path"][:-1]), {})[
                ent["group"]] = ent
        else:
            others.append(ent)

    new_tensor_group = _tensor_group_map(new_plan)
    sgroups = meta_src["groups"]
    manifest = []
    fid = 0
    for prefix, group_ents in sorted(families.items()):
        for gname, entry in new_plan.groups.items():
            dst = GroupIndex.from_entry(entry)
            file = f"o__{fid:03d}"
            fid += 1
            src_ent = group_ents.get(gname)
            want = _entry_meta(entry)
            div = src_ent["div"] if src_ent is not None else next(
                e["div"] for e in group_ents.values())
            same = (src_ent is not None
                    and _same_layout_fields(sgroups[gname], want))
            if same:
                for j in range(dst.num_rows):
                    shutil.copyfile(
                        src_shards / opt_shard_file(src_ent["file"], j),
                        dst_shards / opt_shard_file(file, j))
                dtype = src_ent["dtype"]
            else:
                dtype = _remap_opt_family(prefix, entry, dst, div,
                                          group_ents, src_shards, dst_shards,
                                          file, tensor_src, src_idx)
            manifest.append({"path": list(prefix) + [gname],
                             "kind": "buffer", "group": gname, "div": div,
                             "dtype": dtype, "file": file})
            if verbose:
                print(f"[reshard] opt {'/'.join(prefix)}/{gname}: "
                      f"{'copy' if same else 'stream'}")
    for ent in others:
        file = f"o__{fid:03d}"
        fid += 1
        new_ent = dict(ent, file=file)
        if ent["kind"] == "factor":
            key = ent["path"][-1]
            g_old, rest = key.split("/", 1)
            tname = rest.rsplit("/", 1)[0]
            g_new = new_tensor_group.get(tname)
            if g_new is None:
                raise ValueError(
                    f"optimizer factor {key!r}: tensor {tname!r} not in "
                    f"the new plan")
            if g_new != g_old:
                new_ent["path"] = ent["path"][:-1] + [f"{g_new}/{rest}"]
                new_ent["group"] = g_new
        shutil.copyfile(src_shards / f"{ent['file']}.npy",
                        dst_shards / f"{file}.npy")
        manifest.append(new_ent)
    return manifest


def _remap_opt_family(prefix, entry, dst, div, group_ents, src_shards,
                      dst_shards, file, tensor_src, src_idx):
    L = entry.n_layers or 0
    sl = entry.plan.shard_size // div
    mmaps = None
    dtype = None
    for name in entry.plan.names:
        g_old = tensor_src.get(name)
        src_ent = group_ents.get(g_old) if g_old is not None else None
        if src_ent is None:
            raise ValueError(
                f"optimizer state {'/'.join(prefix)}: no source buffer for "
                f"tensor {name!r} (old group {g_old!r})")
        if src_ent["div"] != div:
            raise ValueError(
                f"optimizer state {'/'.join(prefix)}: block granularity "
                f"changed ({src_ent['div']} -> {div}); 8-bit optimizer "
                f"state cannot cross it -- use --drop-opt")
        read = shard_file_reader(
            src_shards, lambda j, f=src_ent["file"]: opt_shard_file(f, j))
        if mmaps is None:
            probe = np.asarray(read(0, 0 if L else None))
            dtype = probe.dtype
            mmaps = {j: _open_rows(
                dst_shards / opt_shard_file(file, j), L, sl, dtype)
                for j in range(dst.num_rows)}
        s_idx = src_idx[g_old]
        if (s_idx.n_layers or 0) != L:
            raise ValueError(
                f"optimizer state {'/'.join(prefix)}: layer count changed "
                f"for {name!r} ({s_idx.n_layers} -> {L})")
        aligned = div > 1 or np.dtype(dtype).kind in "iu"
        for li in (range(L) if L else [None]):
            copy_tensor(s_idx, dst, name, read, _rows_writer(mmaps),
                        layer=li, div=div, aligned=aligned)
    for mm in (mmaps or {}).values():
        mm.flush()
    return str(dtype) if dtype is not None else "float32"


def build_new_plan(args):
    """The destination ShardingPlan from the arguments, on the host."""
    from ..configs import build_model, get_config, with_tp
    from ..core.policy import plan

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.optimizer:
        cfg = dataclasses.replace(cfg, optimizer=args.optimizer)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.tp == 1:
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, tp=1, ep=1, sequence_parallel=False))
    elif args.tp > 1:
        cfg = with_tp(cfg, args.tp)
    return plan(build_model(cfg), {"data": args.data, "model": args.model},
                args.policies, planner=args.planner)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="reshard a v2 checkpoint for a new world size, "
                    "planner or store format")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--data", type=int, default=1, help="new data axis size")
    ap.add_argument("--model", type=int, default=1,
                    help="new model axis size")
    ap.add_argument("--tp", type=int, default=0,
                    help="override the config's TP degree (1: no tensor "
                         "parallelism; above 1: over the model axis)")
    ap.add_argument("--planner", default="ragged")
    ap.add_argument("--policies", default=None)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--drop-opt", action="store_true",
                    help="omit optimizer state from the output")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    new_plan = build_new_plan(args)
    summary = reshard(args.src, args.dst, new_plan, drop_opt=args.drop_opt,
                      device=args.device)
    print(f"[reshard] done: {len(summary['copied'])} group(s) copied "
          f"bitwise, {len(summary['streamed'])} streamed; "
          f"opt {summary['opt']}")


if __name__ == "__main__":
    main()
