"""veScale-FSDP runtime over ``torch.distributed`` (port of
``repro/core/fsdp.py``: the ZeRO-3 train step on the fp32, bf16, fp8 and
q8_block stores, with cast (fp8 among them) or q8 gradient wires, and the
ZeRO-3 serve steps).

``FSDPRuntime`` wraps a model for a process group.  Construction lowers the
``ParallelConfig`` knobs (or ``schedule=``/``group_schedules=``/
``policies=``) onto a ``ShardingPlan``: per communication group the
planner's RaggedShard placements (Algorithm 1) over the group's ranks and a
flat DBuffer.  Rank r holds columns ``[r*S, (r+1)*S)`` of each group's
buffer (``(L, S)`` for the layer stack, ``(S,)`` otherwise) as a leaf
tensor: the fp32 master (a bf16 store's leaf is its bf16 buffer); an fp8
store adds its float8 codes, a q8_block store its int8 codes and fp32
scales (``(L, S / block)``), and the q8 reduce wire an fp32 error-feedback
residual ``reduce_ef`` (``(L, m * S)``).  The train step then:

  * gathers ``globals`` once and, layer by layer, each layer's shard inside
    one ``torch.utils.checkpoint`` (non-reentrant): forward all-gathers,
    unpacks zero-copy views and computes; backward re-gathers the layer
    (ZeRO-3) and its gather's backward reduce-scatters the gradient
    straight into that layer's row of the stacked leaf's ``.grad`` (the
    q8 reduce wire also writes that layer's new residual into its row of
    ``reduce_ef``);
  * all-reduces the token-sum loss and the token count over the batch
    axes, scales the gradients by ``1/max(tokens, 1)``, runs the
    optimizer (AdamW and Adam8bit: one fused kernel per group, in place, a
    q8 or fp8 store's codes rewritten in the same pass; SGD, Muon and
    Shampoo: tensor code over chunks of the shard, then the store's
    ``rebuild``) and reports the norm of the scaled gradients -- the
    reference's order.  The reference's ``g * scale`` multiplies a bf16
    gradient by an fp32 scalar, which promotes it to fp32; the port keeps
    a bf16 store's gradient bf16 and hands the scale to the optimizer,
    which casts and then scales in fp32 -- the fused kernels per element,
    the others per chunk (``optim.common.grad_f32``): BITWISE the
    reference's scaled gradient, without a full-size fp32 copy.  The
    residual is never scaled and never counted in the norm.

The serve steps (``make_prefill_step``, ``make_decode_step``) run the
model's ``prefill``/``decode`` under ``torch.inference_mode()``: each
layer is gathered just in time (parameters stay sharded at rest), with no
activation checkpoint and no gradient route.  With ``serve_quant_matmul``
a q8_block layer group's payload is gathered as int8 codes and scales and
unpacked by ``DBuffer.unpack_quant`` (eligible weights multiply through
``ops.q8_matmul``); ``globals`` always take the dense gather.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card and without that, construction raises.

PARITY: ``init_params`` and the planned layouts are BITWISE the reference's;
the train step is ALLCLOSE (tests/test_torch_train.py states the bounds),
and so are the serve steps (tests/test_torch_serve.py).
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..launch.mesh import mesh_axes
from ..models.transformer import GroupDef
from ..optim import make_optimizer
from ..quant.fp8 import FP8_DTYPES
from .dbuffer import DBuffer
from .policy import PolicySet, ShardingPlan, plan as make_plan
from .ragged import TensorSpec
from .schedule import CommSchedule
from .store import EF_KEY, ParamStore, check_state
from .wire import payload_all_gather


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    name: str
    gdef: GroupDef
    local_specs: tuple[TensorSpec, ...]
    plan: Any               # GroupPlan
    buffer: DBuffer
    fsdp_axes: tuple[str, ...]
    fsdp_axis_sizes: tuple[int, ...]
    n_layers: int | None
    store: ParamStore = ParamStore()

    def global_shape(self) -> tuple[int, ...]:
        d = (self.plan.total,)
        return (self.n_layers,) + d if self.n_layers else d

    def local_shape(self) -> tuple[int, ...]:
        d = (self.plan.shard_size,)
        return (self.n_layers,) + d if self.n_layers else d


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "FSDPRuntime runs on the card by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class FSDPRuntime:
    def __init__(self, model, group=None, *, planner: str = "ragged",
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 schedule: CommSchedule | None = None,
                 group_schedules: Mapping[str, Any] | None = None,
                 policies=None):
        self.device = _resolve_device(device)
        if group is None:
            if not dist.is_initialized():
                raise RuntimeError(
                    "FSDPRuntime needs a process group: pass one, or create "
                    "the default group first (launch.mesh.init_local_group)")
            group = dist.group.WORLD
        self.group = group
        self.rank = dist.get_rank(group)
        self.model = model
        self.cfg = model.cfg
        self.compute_dtype = compute_dtype
        par = self.cfg.parallel
        if par.microbatches > 1:
            raise NotImplementedError(
                "microbatches > 1 (gradient accumulation, with the deferred "
                "error feedback of the q8 reduce wire) is not ported yet "
                "(ROADMAP Queue 1 item 18)")
        self.axis_sizes = mesh_axes(group)

        if policies is None:
            policies = PolicySet.from_parallel_config(
                par, schedule=schedule, group_schedules=group_schedules)
        elif schedule is not None or group_schedules is not None:
            raise ValueError(
                "pass either policies= or schedule=/group_schedules=, "
                "not both")
        plan: ShardingPlan = make_plan(model, self.axis_sizes, policies,
                                       planner=planner,
                                       compute_dtype=compute_dtype)
        self.plan = plan
        self.schedule = plan.base_schedule()
        self._group_scheds = plan.schedules()
        self.schedule.validate_for(compute_dtype)
        for s in self._group_scheds.values():
            s.validate_for(compute_dtype)

        gdefs = model.groups()
        self.layouts: dict[str, GroupLayout] = {
            name: GroupLayout(
                name=name, gdef=gdefs[name], local_specs=e.local_specs,
                plan=e.plan, buffer=DBuffer(e.plan), fsdp_axes=e.fsdp_axes,
                fsdp_axis_sizes=e.fsdp_axis_sizes, n_layers=e.n_layers,
                store=e.store)
            for name, e in plan.groups.items()
        }
        for lo in self.layouts.values():
            if math.prod(lo.fsdp_axis_sizes) != self.axis_sizes["data"]:
                raise ValueError(
                    f"group {lo.name} shards over {lo.fsdp_axes}, not over "
                    f"the process group's {self.axis_sizes['data']} ranks")
        self.batch_axes = tuple(a for a in par.batch_axes
                                if a in self.axis_sizes)

    def sched_for(self, name: str) -> CommSchedule:
        return self._group_scheds.get(name, self.schedule)

    def _axis_index(self, axis: str) -> int:
        return self.rank if axis == "data" else 0

    def batch_slice(self, batch: int) -> tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a global batch: sharded over
        the longest run of batch axes that divides it, replicated on the
        rest (the reference's ``_usable_batch_axes``/``batch_pspec``)."""
        shards, idx, rem = 1, 0, batch
        for a in self.batch_axes:
            size = self.axis_sizes[a]
            if rem % size == 0 and rem >= size:
                idx = idx * size + self._axis_index(a)
                shards *= size
                rem //= size
        per = batch // shards
        return idx * per, (idx + 1) * per

    # ------------------------------------------------------------------ #
    # state construction
    # ------------------------------------------------------------------ #
    @staticmethod
    def _init_tensor(spec: TensorSpec, seed: int, layer: int | None):
        """Deterministic per-tensor init: identical values regardless of
        how tensors are grouped/sharded (the reference's, line for line)."""
        rng = np.random.default_rng(
            [seed, zlib.crc32(spec.name.encode()),
             0 if layer is None else layer + 1]
        )
        if len(spec.shape) >= 2:
            fan_in = spec.shape[0]
            a = rng.normal(0, 1.0 / math.sqrt(max(fan_in, 1)),
                           size=spec.shape)
        elif any(t in spec.name for t in ("ln", "norm", "skip", "scale")):
            a = np.ones(spec.shape)
        else:
            a = np.zeros(spec.shape)
        return a.astype(np.float32)

    def _place(self, name: str, global_buf: np.ndarray,
               requires_grad: bool = True, dtype=torch.float32,
               axis: int = -1) -> torch.Tensor:
        """This rank's share of a global host buffer, on the device (its
        equal share of ``axis``: the last, the columns, for a group's
        buffer), as ``dtype``.  Masters are leaves that require grad: the
        gather's backward fills their ``.grad``."""
        n = global_buf.shape[axis] // dist.get_world_size(self.group)
        index = [slice(None)] * global_buf.ndim
        index[axis] = slice(self.rank * n, (self.rank + 1) * n)
        local = global_buf[tuple(index)]
        return _host_tensor(local, dtype).to(self.device).requires_grad_(
            requires_grad)

    def init_params(self, seed: int = 0) -> dict[str, Any]:
        """Host-side init; every rank builds the global fp32 buffer, keeps
        its shard on the device and builds its store state there (a bf16
        store rounds it, an fp8 store encodes it, a q8 store quantizes it
        through ``ops.quantize``).  PARITY: BITWISE vs the reference's
        ``init_params``."""
        params = {}
        for name, lo in self.layouts.items():
            layers = list(range(lo.n_layers)) if lo.n_layers else [None]
            flats = [lo.buffer.pack({s.name: self._init_tensor(s, seed, li)
                                     for s in lo.gdef.specs})
                     for li in layers]
            arr = np.stack(flats) if lo.n_layers else flats[0]
            params[name] = lo.store.create(self._place(name, arr))
        return params

    # ------------------------------------------------------------------ #
    # train step
    # ------------------------------------------------------------------ #
    def make_train_step(self, optimizer):
        """``step(params, opt_state, step, batch) -> (params, opt_state,
        step + 1, metrics)``; ``step`` is a Python int (the host counter),
        ``metrics`` holds 0-d device tensors ``loss``, ``tokens`` and
        ``grad_norm`` (reading them is the only host sync).  Parameters and
        optimizer state are updated in place."""
        ef_groups = tuple(n for n, lo in self.layouts.items()
                          if lo.store.has_ef)

        def step_fn(params, opt_state, step: int, batch):
            if not isinstance(step, int):
                raise TypeError(f"step must be a Python int, got {step!r}")
            # the master of each store state (the buffer the reduce-scatter
            # targets) and the rest (q8 codes and scales, the residual,
            # which the gather's backward updates in place); for a bare
            # fp32 state the state itself and nothing
            trainable = {n: self.layouts[n].store.trainable(s)
                         for n, s in params.items()}
            frozen = {n: self.layouts[n].store.frozen(s)
                      for n, s in params.items()}
            for p in trainable.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                else:
                    p.grad.zero_()
            pg = _ParamGetter(self, {
                n: self.layouts[n].store.combine(trainable[n], frozen[n])
                for n in params})
            nll, w = self.model.loss(pg, batch)
            nll.backward()
            with torch.no_grad():
                stats = torch.stack([nll.detach(), w])
                if self.batch_axes:
                    dist.all_reduce(stats, group=self.group)
                nll_g, w_g = stats.unbind()
                grads = {n: p.grad for n, p in trainable.items()}
                scale = 1.0 / torch.clamp(w_g, min=1.0)
                # fp32 gradients are scaled in place; a bf16 one by the
                # optimizer, in fp32 (see the module docstring)
                for g in grads.values():
                    if g.dtype == torch.float32:
                        g.mul_(scale)
                new_params, opt_state = optimizer.update(
                    self, params, grads, opt_state, step, grad_scale=scale)
                # optimizers do not see the residual: re-attach it
                for n in ef_groups:
                    new_params[n] = self.layouts[n].store.attach_ef(
                        new_params[n], params[n][EF_KEY])
                params = new_params
                metrics = {
                    "loss": nll_g / torch.clamp(w_g, min=1.0),
                    "tokens": w_g,
                    "grad_norm": _global_norm(self, grads, scale),
                }
            return params, opt_state, step + 1, metrics

        return step_fn

    # ------------------------------------------------------------------ #
    # serve steps (ZeRO-3 inference: per-layer gather, sharded at rest)
    # ------------------------------------------------------------------ #
    def _serve_call(self, fn, params, batch, cache, *index):
        """Run ``fn(pg, batch, cache, *index)`` (the model's ``prefill`` or
        ``decode``) on this rank's rows ``batch_slice`` gives of the global
        batch, the cache and a per-row index, then all-gather the logit rows
        when the batch is split, so every rank returns the global logits.
        The cache holds the global batch; a rank writes its own rows in
        place."""
        tokens = batch["tokens"]
        B = tokens.shape[0]
        lo, hi = self.batch_slice(B)
        bdims = self.model.cache_batch_dims()
        for k, t in cache.items():
            if t.shape[bdims[k]] != B:
                raise ValueError(
                    f"cache[{k!r}] holds {t.shape[bdims[k]]} rows, the "
                    f"batch {B}")
        local_cache = {k: t.narrow(bdims[k], lo, hi - lo)
                       for k, t in cache.items()}
        local_batch = {k: v[lo:hi] for k, v in batch.items()}
        index = tuple(i[lo:hi] if isinstance(i, torch.Tensor) and i.dim()
                      else i for i in index)
        with torch.inference_mode():
            pg = _ParamGetter(self, params, serve=True,
                              quant_matmul=self.schedule.serve_quant_matmul)
            logits, _ = fn(pg, local_batch, local_cache, *index)
            if hi - lo != B:
                logits = payload_all_gather(logits.reshape(-1),
                                            self.group).view(
                    (B,) + tuple(logits.shape[1:]))
        return logits, cache

    def _check_tokens(self, batch, what: str):
        tokens = batch["tokens"]
        if tokens.device != self.device:
            raise ValueError(
                f"{what}: tokens lie on {tokens.device}, the runtime on "
                f"{self.device}")

    def make_prefill_step(self):
        """``step(params, batch, cache) -> (logits, cache)``: the prompt
        ``batch["tokens"]`` (B, T) from position 0; ``logits`` (B, 1, V) of
        the last position in the compute dtype; ``cache`` (the model's
        ``init_cache(B, max_len, device=...)``) is filled in place and
        returned (the reference donates it)."""

        def step_fn(params, batch, cache):
            self._check_tokens(batch, "prefill")
            return self._serve_call(self.model.prefill, params, batch, cache)

        return step_fn

    def make_decode_step(self):
        """``step(params, batch, cache, index) -> (logits, cache)``: one
        token per row (``batch["tokens"]`` (B, 1)) at position ``index``
        -- an int, or a (B,) integer tensor of per-row positions
        (continuous batching); the cache is updated in place."""

        def step_fn(params, batch, cache, index):
            self._check_tokens(batch, "decode")
            if isinstance(index, torch.Tensor) and index.dim():
                index = index.to(self.device)
            return self._serve_call(self.model.decode, params, batch, cache,
                                    index)

        return step_fn


def _global_norm(runtime: FSDPRuntime, grads, scale) -> torch.Tensor:
    """sqrt of the sum over groups of each group's all-reduced sum of
    squares of the scaled gradients (a bf16 gradient is scaled in fp32
    here, as the fused update scales it; groups added in the reference's
    order)."""
    sq = torch.stack([(g.float() if g.dtype == torch.float32
                       else g.float() * scale).square().sum()
                      for g in grads.values()])
    dist.all_reduce(sq, group=runtime.group)
    return torch.sqrt(sum(sq.unbind()))


_NUMPY_DTYPES = {torch.float32: np.dtype(np.float32),
                 torch.int8: np.dtype(np.int8)}
# dtypes numpy lacks: their arrays (ml_dtypes' bfloat16 and float8, or the
# raw bytes as uint16 / uint8) cross as integer views
_RAW_DTYPES = {torch.bfloat16: np.uint16,
               **{dt: np.uint8 for dt in FP8_DTYPES.values()}}


def _host_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype``: a cast for the dtypes
    numpy has, a bit-for-bit view for bfloat16 and float8 (the array must
    hold that dtype or its raw bytes)."""
    raw = _RAW_DTYPES.get(dtype)
    if raw is None:
        return torch.tensor(np.asarray(a), dtype=dtype)
    a = np.ascontiguousarray(a)
    name = str(dtype).split(".")[-1]
    if a.dtype.name not in (name, np.dtype(raw).name):
        raise ValueError(
            f"a {dtype} leaf needs a {name} array (or its raw "
            f"{np.dtype(raw).name} bytes), got {a.dtype}")
    return torch.from_numpy(a.view(raw).copy()).view(dtype)


def load_reference_state(runtime: FSDPRuntime, params: Mapping[str, Any],
                         opt_state: Mapping[str, Mapping[str, Any]] | None
                         = None):
    """Carry the reference runtime's state across: ``params`` is ``{group:
    state}`` as numpy arrays -- the global flat buffer (``(L, total)`` or
    ``(total,)``) for a bare fp32 or bf16 state, else the dict of the
    store's leaves (``codes``, ``master``, ``scales``, ``reduce_ef``) at
    their global shapes; bf16 buffers and fp8 codes are ml_dtypes arrays or
    their raw uint16 / uint8 bytes, carried bit for bit; ``opt_state``
    optionally the optimizer's state ``{key: {leaf: array}}`` at global
    shapes, checked against the state of the config's optimizer
    (``state_layout``): its keys, and per leaf its dtype and shape --
    AdamW's fp32 ``m``, ``v``, SGD's ``m`` and Muon's and Shampoo's
    ``mom``, ``m``, ``v`` at the buffer's shape per group, 8-bit Adam's
    int8 ``m8``, ``v8`` at the buffer's shape and fp32 ``ms``, ``vs`` at
    ``(..., total / quant_block)``, Shampoo's fp32 ``factors`` as
    ``{"group/tensor/L" | "/R": (Lp, k, k)}`` over the padded layer axis.
    Every leaf's shape is checked against the port's layouts (which are
    bitwise the reference's, so no re-layout is needed); each rank keeps
    its equal share of each leaf's sharded axis (a group leaf's last axis,
    a factor's ``Lp / m`` layer rows) on the runtime's device (the master
    requires grad).  Returns ``(params, opt_state)`` in the port's form
    (``opt_state`` None when not given)."""

    def check_keys(tree, want, what, of):
        if set(tree) != set(want):
            raise ValueError(
                f"{what} {of} {sorted(tree)} do not match the runtime's "
                f"{sorted(want)}")

    check_keys(params, runtime.layouts, "params", "groups")
    new_params = {}
    for name, lo in runtime.layouts.items():
        state = params[name]
        check_state(lo.store, state, lo.global_shape(), f"params[{name!r}]")
        if lo.store.state_keys() is None:
            new_params[name] = runtime._place(name, np.asarray(state), True,
                                              lo.store.storage_dtype)
            continue
        new_params[name] = {
            k: runtime._place(name, np.asarray(state[k]), k == "master",
                              lo.store.leaf_dtype(k))
            for k in lo.store.state_keys()}
    if opt_state is None:
        return new_params, None
    layout = make_optimizer(runtime.cfg).state_layout(runtime)
    if set(opt_state) != set(layout):
        raise ValueError(
            f"opt_state keys {sorted(opt_state)} do not match the "
            f"{runtime.cfg.optimizer} state's {sorted(layout)}")
    new_opt = {}
    for k, leaves in layout.items():
        what = f"opt_state[{k!r}]"
        check_keys(opt_state[k], leaves, what,
                   "leaves" if k == "factors" else "groups")
        new_opt[k] = {}
        for name, (dtype, shape, axis) in leaves.items():
            a = np.asarray(opt_state[k][name])
            if a.shape != shape or a.dtype != _NUMPY_DTYPES[dtype]:
                raise ValueError(
                    f"{what}[{name!r}] is {a.dtype} of shape {a.shape}, the "
                    f"port's layout needs {dtype} of {shape}")
            new_opt[k][name] = runtime._place(name, a, False, dtype, axis)
    return new_params, new_opt


class _ParamGetter:
    """What the model sees of the runtime: gathered, unpacked tensors.

    ``serve``: the serve steps' getter -- gathers without a gradient route
    and runs layers without activation checkpoints (the reference's
    ``remat=False`` getter); ``quant_matmul``: keep q8_block layer groups'
    eligible weights int8 (``DBuffer.unpack_quant``)."""

    def __init__(self, runtime: FSDPRuntime, params, *, serve: bool = False,
                 quant_matmul: bool = False):
        self.rt = runtime
        self.params = params
        self.serve = serve
        self.quant_matmul = quant_matmul
        self.compute_dtype = runtime.compute_dtype

    def _gather(self, name: str, layer: int | None = None) -> torch.Tensor:
        """Gather one group (one layer of a stacked group: row ``layer`` of
        every leaf of its state)."""
        state = self.params[name]
        store = self.rt.layouts[name].store
        sink = None if self.serve else store.trainable(state).grad
        if layer is not None:
            sink = None if sink is None else sink[layer]
            state = _row(state, layer)
        return store.gather(state, sink, self.rt.group,
                            self.rt.sched_for(name), self.compute_dtype)

    def _layer(self, name: str, layer: int) -> dict:
        """One layer of a stacked group, unpacked: the q8 payload into
        ``QuantTensor``s and per-tensor decodes in the serve quant mode,
        else zero-copy views of the gathered buffer."""
        lo = self.rt.layouts[name]
        if self.quant_matmul and lo.store.quantized:
            payload = lo.store.gather_payload(
                _row(self.params[name], layer), self.rt.group)
            return lo.buffer.unpack_quant(payload, lo.store.block,
                                          self.compute_dtype)
        return lo.buffer.unpack(self._gather(name, layer))

    def globals(self, group: str) -> dict[str, torch.Tensor]:
        return self.rt.layouts[group].buffer.unpack(self._gather(group))

    def scan(self, groups, body, carry, xs=None):
        """The FSDP layer loop: for each layer, gather every group's layer
        shard, unpack and run ``body(p, carry, x)`` -> ``(carry, y)``.  In
        training all of it runs inside one non-reentrant activation
        checkpoint, so backward re-gathers the layer (ZeRO-3) and keeps
        only the layer inputs alive between forward and backward; the serve
        getter runs it plainly.  Returns ``(carry, ys)`` (``ys`` None when
        every ``y`` is None)."""
        n = self.rt.layouts[groups[0]].n_layers

        def layer(i, c):
            p = {}
            for g in groups:
                p.update(self._layer(g, i))
            return body(p, c, None if xs is None else xs[i])

        ys = []
        for i in range(n):
            if self.serve:
                carry, y = layer(i, carry)
            else:
                carry, y = checkpoint(layer, i, carry, use_reentrant=False,
                                      preserve_rng_state=False)
            ys.append(y)
        return carry, (None if all(y is None for y in ys) else ys)


def _row(state, layer: int):
    """Row ``layer`` of every leaf of a stacked group's state."""
    if isinstance(state, dict):
        return {k: v[layer] for k, v in state.items()}
    return state[layer]
