"""veScale-FSDP runtime over ``torch.distributed`` (port of
``repro/core/fsdp.py``: the ZeRO-3 train step on the fp32, bf16, fp8 and
q8_block stores, with cast (fp8 among them) or q8 gradient wires, tensor
and expert parallelism over the mesh's model axis, gradient accumulation,
and the ZeRO-3 serve steps).

``FSDPRuntime`` wraps a model for a mesh (``launch.mesh.Mesh``: ``(data,
model)`` over one process group; a bare process group is ``(world,
1)``).  A group the model splits over the model axis (the reference's
outer TP/EP sharding) holds ``outer_size`` rows of its planned buffer, and
rank (d, m) holds row m's FSDP shard over the group's FSDP axes; the
gathers and reduce-scatters run over those axes only.  Construction takes a
``ShardingPlan`` (``plan=``, e.g. a checkpoint's ``load_plan``, checked
against the group's mesh and the compute dtype) or resolves one from the
``ParallelConfig`` knobs, ``schedule=``/``group_schedules=`` or
``policies=`` (``"auto"``: the ``cost_model``'s choices): per
communication group the
planner's RaggedShard placements (Algorithm 1) over the group's ranks and a
flat DBuffer.  Rank r holds columns ``[r*S, (r+1)*S)`` of each group's
buffer (``(L, S)`` for the layer stack, ``(S,)`` otherwise) as a leaf
tensor: the fp32 master (a bf16 store's leaf is its bf16 buffer); an fp8
store adds its float8 codes, a q8_block store its int8 codes and fp32
scales (``(L, S / block)``), and the q8 reduce wire an fp32 error-feedback
residual ``reduce_ef`` (``(L, m * S)``).  The train step then:

  * gathers ``globals`` once and runs the layer loop the schedule's
    ``LayerPlan`` lays out (``_ParamGetter.scan``).  By default each
    layer's gather, unpack and compute run inside one
    ``torch.utils.checkpoint`` (non-reentrant), so backward re-gathers the
    layer (ZeRO-3); ``prefetch`` checkpoints layer pairs whose two gathers
    are issued before either layer's compute; ``reshard_after_forward=
    False`` gathers outside the checkpoint, so every gathered buffer is
    saved into backward; ``keep_last_gathered`` does so for the last layer
    alone.  Each gather's backward reduce-scatters the gradient straight
    into that layer's row of the stacked leaf's ``.grad`` (the q8 reduce
    wire also writes that layer's new residual into its row of
    ``reduce_ef``).  An unsharded group (``sharded=False``) is held whole
    on every rank: its gather moves nothing and its gradient is
    all-reduced over the process group after backward, in the schedule's
    accumulate dtype when ``reduce_dtype`` or ``reduce_wire`` pins one
    (the reference's ``_reduce_grads``);
  * with ``microbatches`` > 1 runs forward and backward per microbatch,
    the gradients accumulating in ``.grad`` (a q8 reduce wire defers its
    error feedback to the accumulation boundary: ``make_train_step``);
    all-reduces ``layers_rep``'s gradient over the model axis under tensor
    parallelism;
  * all-reduces the token-sum loss and the token count over the batch
    axes, scales the gradients by ``1/max(tokens, 1)`` (and by the model
    axis's size where it holds the same tokens on each rank and sums
    their gradients: ``_grad_div``), runs the
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

``replan`` moves live parameters and optimizer state onto another plan of
the same model on the same process group (``core.reshard``'s extent map;
the classes of a checkpoint load).  Serving, ``replan`` and checkpoints on
a mesh with a model axis raise (ROADMAP Queue 1 item 18b).

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card and without that, construction raises.

PARITY: ``init_params`` and the planned layouts are BITWISE the reference's;
the train step is ALLCLOSE (tests/test_torch_train.py states the bounds),
and so are the serve steps (tests/test_torch_serve.py).  Under a model
axis the step follows the one-device gradient, which the reference's does
not (tp or ep times it where a batch is replicated over the axis; ROADMAP
Queue 3, tests/test_torch_tp.py, tests/test_torch_ep.py).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
import zlib
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..launch.mesh import AXES, as_mesh
from ..models.transformer import GroupDef
from ..optim import make_optimizer
from ..quant.fp8 import FP8_DTYPES
from .dbuffer import DBuffer
from .policy import PolicySet, ShardingPlan, plan as make_plan
from .ragged import TensorSpec
from .schedule import CommSchedule
from .store import EF_KEY, ParamStore, check_state
from .wire import codec_reduce_scatter, payload_all_gather


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
    # the axes an unsharded group's gradient is all-reduced over
    grad_sync_axes: tuple[str, ...] = ()
    # the TP/EP axis the buffer is split on before FSDP (the reference's
    # outer sharding, paper Fig. 5): ``outer_size`` rows of ``plan.total``
    outer_axis: str | None = None
    outer_size: int = 1

    @property
    def sharded(self) -> bool:
        return bool(self.fsdp_axes)

    @property
    def sharded_dim(self) -> int:
        return self.outer_size * self.plan.total

    def global_shape(self) -> tuple[int, ...]:
        d = (self.sharded_dim,)
        return (self.n_layers,) + d if self.n_layers else d

    def local_shape(self) -> tuple[int, ...]:
        d = (self.plan.shard_size,)
        return (self.n_layers,) + d if self.n_layers else d

    @property
    def dup_names(self) -> tuple[str, ...]:
        """Tensors of an outer-split group that are not split: every outer
        row holds a whole copy (``globals``' ``final_ln`` under tp)."""
        if self.outer_size == 1:
            return ()
        return tuple(s.name for s in self.gdef.specs
                     if s.name not in self.gdef.outer)


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
                 policies=None, plan: ShardingPlan | None = None,
                 cost_model=None):
        self.device = _resolve_device(device)
        if group is None:
            if not dist.is_initialized():
                raise RuntimeError(
                    "FSDPRuntime needs a process group: pass one, or create "
                    "the default group first (launch.mesh.init_local_group)")
            group = dist.group.WORLD
        self.mesh = as_mesh(group)
        self.group = self.mesh.group
        self.rank = dist.get_rank(self.group)
        self.model = model
        self.cfg = model.cfg
        self.compute_dtype = compute_dtype
        par = self.cfg.parallel
        self.axis_sizes = dict(self.mesh.axis_sizes)

        # the plan the runtime consumes: an explicit one (say, a
        # checkpoint's), a policies spec ("auto" among them), or the
        # config's knobs with the schedule/group_schedules overrides
        if plan is not None:
            if (policies is not None or schedule is not None
                    or group_schedules is not None):
                raise ValueError(
                    "pass either plan= or policies=/schedule="
                    "/group_schedules=, not both")
            got = {a: int(n) for a, n in plan.axis_sizes.items()}
            if got != self.axis_sizes:
                raise ValueError(
                    f"plan was resolved for mesh axes {got}, the runtime's "
                    f"process group has {self.axis_sizes}; re-plan for it")
            cd_name = str(compute_dtype).split(".")[-1]
            if plan.compute_dtype != cd_name:
                raise ValueError(
                    f"plan was resolved for compute dtype "
                    f"{plan.compute_dtype}, the runtime uses {cd_name}")
            if set(plan.groups) != set(model.groups()):
                raise ValueError(
                    f"plan groups {sorted(plan.groups)} do not match this "
                    f"model's groups {sorted(model.groups())}")
        else:
            if policies is None:
                policies = PolicySet.from_parallel_config(
                    par, schedule=schedule, group_schedules=group_schedules)
            elif schedule is not None or group_schedules is not None:
                raise ValueError(
                    "pass either policies= or schedule=/group_schedules=, "
                    "not both")
            plan = make_plan(model, self.axis_sizes, policies,
                             planner=planner, compute_dtype=compute_dtype,
                             cost_model=cost_model)
        self.plan = plan
        self.planner_mode = plan.planner
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
                store=e.store, grad_sync_axes=e.grad_sync_axes,
                outer_axis=e.outer_axis, outer_size=e.outer_size)
            for name, e in plan.groups.items()
        }
        # instrumentation, off by default: a GatheredMeter here records the
        # live and peak bytes of the gathered layer buffers
        self.gathered_meter: GatheredMeter | None = None
        for lo in self.layouts.values():
            for axes in (lo.fsdp_axes, lo.grad_sync_axes):
                if axes != tuple(a for a in AXES if a in axes):
                    raise ValueError(
                        f"group {lo.name} spans mesh axes {axes}; the port "
                        f"takes them in the mesh's order {AXES}")
        # the model axis: tensor parallelism (activations split over it)
        # or expert parallelism (experts split over it), never both
        self.tp, self.ep = par.tp, par.ep
        model_size = self.axis_sizes["model"]
        for what, n in (("tp", par.tp), ("ep", par.ep)):
            if n > 1 and n != model_size:
                raise ValueError(
                    f"{what}={n} runs over the mesh's model axis, which has "
                    f"{model_size} ranks")
        if par.tp > 1 and par.ep > 1:
            raise ValueError("tp and ep both take the model axis")
        self.tp_axis = "model" if par.tp > 1 else None
        self.ep_axis = "model" if par.ep > 1 else None
        self.model_group = self.mesh.group_for(("model",))
        self.batch_axes = tuple(a for a in par.batch_axes
                                if a in self.axis_sizes)
        if par.tp > 1 and "model" in self.batch_axes:
            raise ValueError(
                "tensor parallelism needs the same tokens on every rank of "
                "the model axis: batch_axes must not include 'model'")
        if (model_size > 1 and par.tp == 1 and par.ep == 1
                and not any("model" in lo.fsdp_axes + lo.grad_sync_axes
                            for lo in self.layouts.values())):
            raise ValueError(
                f"the mesh's model axis ({model_size} ranks) carries "
                f"neither tp, ep nor FSDP")

    def sched_for(self, name: str) -> CommSchedule:
        return self._group_scheds.get(name, self.schedule)

    def group_of(self, name: str):
        """The process group a group's gather and reduce-scatter run over
        (its FSDP axes: never across the outer axis, whose rows hold other
        parts of the tensors): None for an unsharded group, which gathers
        nothing."""
        lo = self.layouts[name]
        return self.mesh.group_for(lo.fsdp_axes) if lo.sharded else None

    # ------------------------------------------------------------------ #
    # accounting (the reference's, from the plan)
    # ------------------------------------------------------------------ #
    def gathered_peak_bytes(self) -> int:
        """Analytic peak of simultaneously live gathered layer buffers in
        the train step: 2 slots with prefetch, 1 without, +1 for the
        split-out last layer, or every layer without resharding.
        PARITY: BITWISE vs the reference's ``gathered_peak_bytes``."""
        itemsize = self.compute_dtype.itemsize
        per_layer, n = 0, 0
        for lo in self.layouts.values():
            if lo.n_layers and lo.sharded:
                per_layer += lo.plan.total * itemsize
                n = max(n, lo.n_layers)
        if not n:
            return 0
        if not self.schedule.reshard_after_forward:
            slots = n
        else:
            lp = self.schedule.plan_layers(n, remat=True)
            main_slots = (2 if lp.prefetch else 1) if lp.main else 0
            slots = main_slots + int(lp.split_last)
        return per_layer * slots

    def gather_wire_bytes(self) -> int:
        """Bytes the parameter all-gathers of one forward pass put on the
        wire, per gathered copy (``ShardingPlan.gather_wire_bytes``)."""
        return self.plan.gather_wire_bytes()

    def reduce_wire_bytes(self) -> int:
        """Bytes one gradient reduce-scatter pass puts on the wire, per
        reduced copy (``ShardingPlan.reduce_wire_bytes``)."""
        return self.plan.reduce_wire_bytes()

    def _axis_index(self, axis: str) -> int:
        return self.mesh.coords[axis]

    def batch_slice(self, batch: int) -> tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a global batch: sharded over
        the longest run of batch axes that divides it, replicated on the
        rest (the reference's ``_usable_batch_axes``/``batch_pspec``)."""
        usable, rem = [], batch
        for a in self.batch_axes:
            size = self.axis_sizes[a]
            if rem % size == 0 and rem >= size:
                usable.append(a)
                rem //= size
        per = batch // self.mesh.size(usable)
        idx = self.mesh.index(usable)
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

    def _block_index(self, lo: GroupLayout) -> int:
        """This rank's column block of a group's global buffer: the
        blocks run over the outer axis, then the FSDP axes, row-major (the
        reference's pspec ``(outer_axis, *fsdp_axes)``)."""
        idx = self.mesh.coords[lo.outer_axis] if lo.outer_axis else 0
        if lo.sharded:
            idx = idx * math.prod(lo.fsdp_axis_sizes) \
                + self.mesh.index(lo.fsdp_axes)
        return idx

    def _place(self, name: str, global_buf: np.ndarray,
               requires_grad: bool = True, dtype=torch.float32,
               axis: int | None = -1) -> torch.Tensor:
        """This rank's share of a global host buffer, on the device (its
        column block of ``axis`` -- the last, for a group's buffer and its
        optimizer leaves: ``outer_size`` rows of the group's FSDP shards,
        or of the whole buffer for an unsharded group; None: the whole
        array; a leaf that is not a group's buffer takes an equal share per
        rank), as ``dtype``.  Masters are leaves that require grad: the
        gather's backward fills their ``.grad``."""
        local = global_buf
        if axis is not None:
            lo = self.layouts.get(name)
            if lo is None:
                # not a group's buffer (Shampoo's factors): an equal share
                # per rank of the process group
                blocks, i = dist.get_world_size(self.group), self.rank
            else:
                blocks = lo.outer_size * (math.prod(lo.fsdp_axis_sizes)
                                          if lo.sharded else 1)
                i = self._block_index(lo)
            n = global_buf.shape[axis] // blocks
            index = [slice(None)] * global_buf.ndim
            index[axis] = slice(i * n, (i + 1) * n)
            local = global_buf[tuple(index)]
        return _host_tensor(local, dtype).to(self.device).requires_grad_(
            requires_grad)

    def init_params(self, seed: int = 0) -> dict[str, Any]:
        """Host-side init; every rank builds its outer row of the global
        fp32 buffer (the tensors split over the outer axis cut to this
        rank's part), keeps its shard on the device and builds its store
        state there (a bf16 store rounds it, an fp8 store encodes it, a q8
        store quantizes it through ``ops.quantize``).  PARITY: BITWISE vs
        the reference's ``init_params`` (this rank's columns of it)."""
        params = {}
        for name, lo in self.layouts.items():
            r = self.mesh.coords[lo.outer_axis] if lo.outer_axis else 0
            layers = list(range(lo.n_layers)) if lo.n_layers else [None]
            flats = []
            for li in layers:
                arrays = {}
                for s in lo.gdef.specs:
                    a = self._init_tensor(s, seed, li)
                    sd = lo.gdef.outer.get(s.name)
                    if sd is not None and lo.outer_size > 1:
                        a = np.split(a, lo.outer_size, axis=sd.dim)[r]
                    arrays[s.name] = a
                flats.append(lo.buffer.pack(arrays))
            arr = np.stack(flats) if lo.n_layers else flats[0]
            n = lo.plan.shard_size if lo.sharded else lo.plan.total
            f = self.mesh.index(lo.fsdp_axes) if lo.sharded else 0
            params[name] = lo.store.create(
                _host_tensor(arr[..., f * n:(f + 1) * n], torch.float32)
                .to(self.device).requires_grad_(True))
        return params

    # ------------------------------------------------------------------ #
    # in-job resharding
    # ------------------------------------------------------------------ #
    def replan(self, params, opt_state=None, *, plan: ShardingPlan | None
               = None, policies=None, schedule: CommSchedule | None = None,
               group_schedules: Mapping[str, Any] | None = None,
               planner: str | None = None, cost_model=None, optimizer=None,
               mesh: Mapping[str, int] | None = None):
        """Move live state onto a new plan of the same model on the same
        process group -- new policies (``"auto"`` among them), store
        formats, planner or schedule -- without a save/load round trip.
        Returns ``(new_runtime, new_params, new_opt_state)``
        (``new_opt_state`` None unless ``opt_state`` and ``optimizer`` are
        given; ``optimizer`` is initialised for the new runtime).

        ``layout_changed_groups`` splits the groups: an unchanged layout
        and store keeps its state tensors as they are (bitwise, the
        residual included); a changed group streams its fp32 master tensor
        by tensor through the extent map into this rank's row (gathering
        the old group's shards over the process group) and rebuilds its
        store (codes requantized, the residual zero).  Optimizer buffers
        follow their tensors' extents, Shampoo's factors are re-padded --
        the classes of a checkpoint load.  Another world size goes
        through ``checkpoint.save`` and ``load``; a mesh with a model axis
        raises (ROADMAP Queue 1 item 18b)."""
        from .policy import layout_changed_groups
        from .reshard import (GroupIndex, buffer_reader, row_writer,
                              stream_tensors)

        if self.axis_sizes["model"] > 1 or (
                mesh is not None and int(mesh.get("model", 1)) > 1):
            raise NotImplementedError(
                "replan on or onto a mesh with a model axis (tensor or "
                "expert parallelism) is not ported yet (ROADMAP Queue 1 "
                "item 18b)")
        if mesh is not None:
            mesh = {a: int(n) for a, n in mesh.items()}
            if mesh.get("data", 1) != self.axis_sizes["data"]:
                raise ValueError(
                    f"replan stays on the runtime's process group "
                    f"({self.axis_sizes['data']} ranks); move to "
                    f"{mesh.get('data', 1)} ranks through checkpoint.save "
                    f"and checkpoint.load")
        kwargs: dict[str, Any] = {}
        if plan is not None:
            kwargs["plan"] = plan
        elif policies is not None:
            kwargs.update(policies=policies, cost_model=cost_model)
        elif schedule is not None or group_schedules is not None:
            kwargs.update(schedule=schedule, group_schedules=group_schedules)
        else:
            # keep this runtime's resolved per-group decisions
            kwargs["policies"] = self.plan.policy_set()
        new_rt = FSDPRuntime(self.model, self.group,
                             planner=planner or self.planner_mode,
                             compute_dtype=self.compute_dtype,
                             device=self.device, **kwargs)

        changed = layout_changed_groups(self.plan, new_rt.plan)
        old_idx = {n: GroupIndex.from_layout(lo)
                   for n, lo in self.layouts.items()}
        tensor_src = {t: n for n, lo in self.layouts.items()
                      for t in lo.plan.names}
        masters: dict[str, np.ndarray] = {}

        def src_master(gname: str) -> np.ndarray:
            if gname not in masters:
                lo = self.layouts[gname]
                t = lo.store.trainable(params[gname]).detach().float()
                masters[gname] = self._host_global(
                    t, -1 if lo.sharded else None)
            return masters[gname]

        new_params = {}
        for name, lo in new_rt.layouts.items():
            if name in self.layouts and name not in changed:
                new_params[name] = params[name]
                continue
            master = np.zeros(lo.local_shape() if lo.sharded
                              else lo.global_shape(), np.float32)

            def lookup(tname, name=name):
                g = tensor_src.get(tname)
                if g is None:
                    raise ValueError(
                        f"tensor {tname!r} (group {name!r}) does not exist "
                        f"in the current runtime; replan cannot invent "
                        f"parameters")
                return old_idx[g], buffer_reader(src_master(g),
                                                 old_idx[g].num_rows)

            stream_tensors(GroupIndex.from_layout(lo),
                           row_writer(master, new_rt.rank
                                       if lo.sharded else 0), lookup)
            new_params[name] = lo.store.create(
                torch.from_numpy(master).to(self.device).requires_grad_())
        if opt_state is None:
            return new_rt, new_params, None
        if optimizer is None:
            raise ValueError(
                "replan(opt_state=...) needs optimizer= to lay out the new "
                "state")
        old_layout = optimizer.state_layout(self)
        like = optimizer.init(new_rt)
        gathered: dict[tuple[str, str], np.ndarray] = {}
        new_opt = {}
        for k, leaves in optimizer.state_layout(new_rt).items():
            new_opt[k] = {}
            for leaf, (dtype, shape, axis) in leaves.items():
                new_opt[k][leaf] = self._replan_opt_leaf(
                    new_rt, (k, leaf), shape, axis, like[k][leaf],
                    opt_state, old_layout, old_idx, tensor_src, changed,
                    gathered)
        return new_rt, new_params, new_opt

    def _host_global(self, t: torch.Tensor, axis) -> np.ndarray:
        """The global host array of a rank-local tensor sharded along
        ``axis`` over the process group (``t`` itself for None)."""
        world = dist.get_world_size(self.group)
        if axis is None or world == 1:
            return t.detach().cpu().numpy()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=axis).cpu().numpy()

    def _replan_opt_leaf(self, new_rt, keys, shape, axis, like, opt_state,
                         old_layout, old_idx, tensor_src, changed, gathered):
        from ..checkpoint.ckpt import _classify_opt_leaf, _share
        from .reshard import (GroupIndex, buffer_reader, copy_tensor,
                              row_writer)

        pathname = "/".join(keys)
        kind, g_new, div = _classify_opt_leaf(new_rt, keys, shape)
        old = opt_state.get(keys[0], {}).get(keys[1])
        if kind != "buffer":
            if old is None:
                raise ValueError(
                    f"optimizer state leaf {pathname!r} has no counterpart "
                    f"in the current state")
            a = self._host_global(old, old_layout[keys[0]][keys[1]][2])
            if kind == "factor":
                L = self.layouts[g_new].n_layers
                if a.shape[1:] != tuple(shape[1:]) or shape[0] < L:
                    raise ValueError(
                        f"optimizer state {pathname!r}: factor shape "
                        f"{a.shape} incompatible with {tuple(shape)}")
                out = np.zeros(shape, a.dtype)
                out[:L] = a[:L]
                a = out
            elif tuple(a.shape) != tuple(shape):
                raise ValueError(
                    f"optimizer state {pathname!r}: shape {a.shape} != "
                    f"expected {tuple(shape)}")
            return like.copy_(torch.from_numpy(
                np.ascontiguousarray(_share(new_rt, a, axis))))
        lo = new_rt.layouts[g_new]
        if g_new not in changed and old is not None \
                and old.shape == like.shape:
            return old
        dst = GroupIndex.from_layout(lo)
        dest = np.zeros(tuple(like.shape), _NUMPY_DTYPES[like.dtype])
        write = row_writer(dest, new_rt.rank if lo.sharded else 0)
        aligned = div > 1 or dest.dtype.kind in "iu"
        for name in lo.plan.names:
            g_old = tensor_src.get(name)
            src = opt_state.get(keys[0], {}).get(g_old) \
                if g_old is not None else None
            if src is None:
                raise ValueError(
                    f"optimizer state {pathname!r}: no source buffer for "
                    f"tensor {name!r} (old group {g_old!r})")
            s_lo = self.layouts[g_old]
            if (keys[0], g_old) not in gathered:
                gathered[keys[0], g_old] = self._host_global(
                    src, -1 if s_lo.sharded else None)
            src = gathered[keys[0], g_old]
            src_div = s_lo.global_shape()[-1] // src.shape[-1]
            if src_div != div:
                raise ValueError(
                    f"optimizer state {pathname!r}: block granularity "
                    f"changed ({src_div} -> {div}); 8-bit optimizer state "
                    f"cannot be resharded across it")
            s_idx = old_idx[g_old]
            if (s_idx.n_layers or 0) != (lo.n_layers or 0):
                raise ValueError(
                    f"optimizer state {pathname!r}: layer count changed "
                    f"for {name!r} ({s_idx.n_layers} -> {lo.n_layers})")
            read = buffer_reader(src, s_idx.num_rows)
            for li in (range(lo.n_layers) if lo.n_layers else [None]):
                copy_tensor(s_idx, dst, name, read, write,
                            layer=li, div=div, aligned=aligned)
        return like.copy_(torch.from_numpy(dest))

    # ------------------------------------------------------------------ #
    # train step
    # ------------------------------------------------------------------ #
    def make_train_step(self, optimizer):
        """``step(params, opt_state, step, batch) -> (params, opt_state,
        step + 1, metrics)``; ``step`` is a Python int (the host counter),
        ``metrics`` holds 0-d device tensors ``loss``, ``tokens`` and
        ``grad_norm`` (reading them is the only host sync).  Parameters and
        optimizer state are updated in place.

        With ``microbatches`` > 1 (clamped to a divisor of the local batch)
        each microbatch runs forward and backward in turn, its gradients
        accumulating in ``.grad``; a group with the q8 reduce wire then
        defers its error feedback: no microbatch's backward encodes or
        reduces, each adds its fp32 cotangent to a gathered-size
        accumulator, and at the accumulation boundary one
        ``codec_reduce_scatter`` per layer applies the residual, encodes
        and reduce-scatters -- the wire numerics and residual of one batch
        of the same size (the reference's deferred EF)."""
        par = self.cfg.parallel
        ef_groups = tuple(n for n, lo in self.layouts.items()
                          if lo.store.has_ef)
        for n in ef_groups:
            # a model-replicated group's gradient is all-reduced over the
            # model axis after its reduce-scatter: each replica would keep
            # its own residual (the reference's ValueError)
            if self.layouts[n].gdef.replicated_over_model and self.tp > 1:
                raise ValueError(
                    f"reduce_wire='q8_block' on group {n!r} is unsupported "
                    f"with replica gradient axes ['model']: the error-"
                    f"feedback residual would diverge across replicas "
                    f"(quantized replica reductions are future work; use a "
                    f"cast reduce wire for this group)")

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
            state = {n: self.layouts[n].store.combine(trainable[n],
                                                      frozen[n])
                     for n in params}
            b_loc = next(iter(batch.values())).shape[0]
            micro = par.microbatches
            while b_loc % micro:
                micro -= 1
            # deferred EF: each group's fp32 cotangent sum, gathered-sized
            defer = {n: torch.zeros_like(params[n][EF_KEY])
                     for n in ef_groups} if micro > 1 else None
            nll = w = None
            per = b_loc // micro
            for i in range(micro):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                pg = _ParamGetter(self, state, defer=defer)
                nll_i, w_i = self.model.loss(pg, mb)
                nll_i.backward()
                nll_i = nll_i.detach()
                nll, w = (nll_i, w_i) if nll is None else (nll + nll_i,
                                                          w + w_i)
            with torch.no_grad():
                if defer is not None:
                    self._boundary_reduce(params, trainable, defer)
                self._reduce_grads(trainable)
                stats = torch.stack([nll, w])
                bgroup = self.mesh.group_for(self.batch_axes)
                if bgroup is not None:
                    dist.all_reduce(stats, group=bgroup)
                nll_g, w_g = stats.unbind()
                grads = {n: p.grad for n, p in trainable.items()}
                scale = 1.0 / torch.clamp(w_g, min=1.0)
                if self._grad_div > 1:
                    scale = scale / self._grad_div
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

    @property
    def _grad_div(self) -> int:
        """How many times the gradient sums each token beyond the batch
        axes' count: a model axis that is not a batch axis and not the
        tensor-parallel axis (expert parallelism, or FSDP over it) holds
        the same tokens on each of its ranks and sums their gradients.
        The reference sums them (its gradient is that many times the
        one-device gradient); the port divides, so each token counts once.
        Under tensor parallelism the conjugate collectives of
        ``models.layers`` give each rank the true gradient already."""
        m = self.axis_sizes["model"]
        if m > 1 and self.tp == 1 and "model" not in self.batch_axes:
            return m
        return 1

    @torch.no_grad()
    def _boundary_reduce(self, params, trainable, defer) -> None:
        """The accumulation boundary of the deferred EF groups: per layer,
        the summed cotangent, the residual and one ``codec_reduce_scatter``
        (encode once, route, decode) into the master's gradient; the new
        residual replaces the old in place (the reference's boundary
        ``lax.scan`` of ``codec_reduce_scatter``)."""
        for n, acc in defer.items():
            lo, sched = self.layouts[n], self.sched_for(n)
            rcodec = sched.reduce_codec(self.compute_dtype, lo.store.block)
            ef, grad = params[n][EF_KEY], trainable[n].grad
            for row in (range(lo.n_layers) if lo.n_layers else [None]):
                at = (lambda t: t) if row is None else (lambda t: t[row])
                at(grad).copy_(codec_reduce_scatter(
                    at(acc), at(ef), rcodec, self.group_of(n), grad.dtype,
                    sched.gather_mode, sched.reduce_mode,
                    sched.ring_chunk_elems))

    @torch.no_grad()
    def _reduce_grads(self, trainable) -> None:
        """The reductions beyond each gather's reduce-scatter, in place: a
        model-replicated group (``layers_rep``) all-reduces its gradient
        over the model axis under tp (each rank holds its partial sum),
        and an unsharded group over its ``grad_sync_axes``; in the
        schedule's accumulate dtype when ``reduce_dtype`` or
        ``reduce_wire`` pins one (the casts run on one rank too, as the
        reference's psum over a size-1 axis keeps them), else in the
        gradient's own dtype (the reference's ``_reduce_grads``)."""
        for name, p in trainable.items():
            lo = self.layouts[name]
            axes = []
            if lo.gdef.replicated_over_model and self.tp > 1:
                axes.append(("model",))
            if lo.grad_sync_axes:
                axes.append(lo.grad_sync_axes)
            if not axes:
                continue
            g, sched = p.grad, self.sched_for(name)
            pinned = (sched.reduce_dtype is not None
                      or sched.reduce_wire is not None)
            ad = sched.accum_dtype(self.compute_dtype) if pinned else g.dtype
            for a in axes:
                t = g if ad == g.dtype else g.to(ad)
                dist.all_reduce(t, group=self.mesh.group_for(a))
                if t is not g:
                    g.copy_(t)

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
        if self.axis_sizes["model"] > 1:
            raise NotImplementedError(
                "serving on a mesh with a model axis (the replicated-KV "
                "cache layout of tensor parallelism) is not ported yet "
                "(ROADMAP Queue 1 item 18b)")
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
    """sqrt of the sum over groups of each group's sum of squares of the
    scaled gradients (a bf16 gradient is scaled in fp32 here, as the fused
    update scales it), each parameter counted once: a group's sums are
    all-reduced over the process group from one rank of each distinct
    shard (the ranks at index 0 of every mesh axis the group is neither
    sharded nor split over, whose ranks hold the same gradient), the
    copies an outer-split group keeps of its unsplit tensors count on
    outer row 0 alone, and a group unsharded and unsplit holds the whole
    gradient on every rank.  Groups are added in the reference's order.
    The reference counts such copies once per outer row; its norm also
    carries its gradient's factor (ROADMAP Queue 3)."""
    mesh = runtime.mesh
    sq, reduce = [], []
    for name, g in grads.items():
        lo = runtime.layouts[name]
        g = g.float() if g.dtype == torch.float32 else g.float() * scale
        if lo.dup_names and mesh.coords[lo.outer_axis]:
            g = g[..., _unique_cols(runtime, lo)]
        s = g.square().sum()
        owned = lo.fsdp_axes + ((lo.outer_axis,) if lo.outer_axis else ())
        if owned and any(mesh.coords[a] for a in AXES if a not in owned):
            s = torch.zeros_like(s)
        sq.append(s)
        reduce.append(bool(owned))
    if any(reduce):
        part = torch.stack([s if r else torch.zeros_like(s)
                            for s, r in zip(sq, reduce)])
        dist.all_reduce(part, group=runtime.group)
        sq = [p if r else s for p, s, r in zip(part.unbind(), sq, reduce)]
    return torch.sqrt(sum(sq))


def _unique_cols(runtime: FSDPRuntime, lo: GroupLayout) -> torch.Tensor:
    """The local columns of an outer-split group's shard that hold split
    tensors (every column but those of its ``dup_names`` copies)."""
    keep = np.ones(lo.plan.shard_size, bool)
    f = runtime.mesh.index(lo.fsdp_axes) if lo.sharded else 0
    for name in lo.dup_names:
        for e in lo.plan.tensor_extents(name):
            if e.shard == f:
                keep[e.lo:e.hi] = False
    return torch.from_numpy(np.flatnonzero(keep)).to(runtime.device)


class GatheredMeter:
    """Live and peak bytes of the gathered layer buffers of a runtime
    (set ``FSDPRuntime.gathered_meter``): each buffer counts from its
    gather until autograd and the model release it (a view of it keeps it
    alive), so the peak is the measured counterpart of
    ``FSDPRuntime.gathered_peak_bytes``."""

    def __init__(self):
        self.live = self.peak = self.gathers = 0

    def add(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        self.live += n
        self.gathers += 1
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n


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
    state}`` as numpy arrays -- the global flat buffer (``(L, outer_size *
    total)`` or ``(outer_size * total,)``) for a bare fp32 or bf16 state,
    else the dict of the
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
    its share of each leaf's sharded axis (of a group leaf's last axis its
    column block: its outer row's FSDP shard, the whole outer row of an
    unsharded group; a factor's ``Lp / m`` layer rows; the whole leaf of
    an unsharded, unsplit group) on the runtime's device (the master
    requires grad).  Returns
    ``(params, opt_state)`` in the port's form (``opt_state`` None when
    not given)."""

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
        axis = -1 if lo.sharded or lo.outer_size > 1 else None
        if lo.store.state_keys() is None:
            new_params[name] = runtime._place(name, np.asarray(state), True,
                                              lo.store.storage_dtype, axis)
            continue
        new_params[name] = {
            k: runtime._place(name, np.asarray(state[k]), k == "master",
                              lo.store.leaf_dtype(k), axis)
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
                 quant_matmul: bool = False, defer=None):
        self.rt = runtime
        self.params = params
        self.serve = serve
        self.quant_matmul = quant_matmul
        # deferred EF: {group: fp32 cotangent accumulator}, whose groups'
        # gathers add their cotangent there instead of reducing it
        self.defer = defer or {}
        self.compute_dtype = runtime.compute_dtype
        # the model axis: the TP group (activations) and the EP group
        # (expert exchange), None where the config has neither
        self.tp_group = runtime.model_group if runtime.tp > 1 else None
        self.ep_group = runtime.model_group if runtime.ep > 1 else None
        self.tp_rank = runtime.mesh.coords["model"] if runtime.tp > 1 else 0

    def _state(self, name: str, layer: int | None):
        state = self.params[name]
        return state if layer is None else _row(state, layer)

    def _quant(self, name: str, layer: int | None) -> bool:
        """The serve quant mode's layer gathers keep the q8 payload
        (``globals`` always take the dense gather)."""
        return (self.quant_matmul and layer is not None
                and self.rt.layouts[name].store.quantized)

    def _start(self, name: str, layer: int | None = None):
        """Issue one group's gather (one layer of a stacked group: row
        ``layer`` of every leaf of its state) without waiting; None in the
        serve quant mode, whose payload gather is not split."""
        if self._quant(name, layer):
            return None
        return self.rt.layouts[name].store.start_gather(
            self._state(name, layer), self.rt.group_of(name),
            self.rt.sched_for(name), self.compute_dtype)

    def _gather(self, name: str, layer: int | None = None, started=None):
        """Gather one group (or one layer of it): the flat compute-dtype
        buffer, or in the serve quant mode the q8 payload.  ``started``:
        its ``_start``, issued earlier."""
        lo = self.rt.layouts[name]
        state = self._state(name, layer)
        if self._quant(name, layer):
            return lo.store.gather_payload(state, self.rt.group_of(name),
                                           self.rt.sched_for(name))
        sink = None if self.serve else \
            lo.store.trainable(self.params[name]).grad
        acc = self.defer.get(name)
        if layer is not None and sink is not None:
            sink = sink[layer]
            acc = None if acc is None else acc[layer]
        out = lo.store.gather(state, sink, self.rt.group_of(name),
                              self.rt.sched_for(name), self.compute_dtype,
                              started, defer_acc=acc)
        meter = self.rt.gathered_meter
        if meter is not None and layer is not None and lo.sharded:
            meter.add(out)
        return out

    def _unpack(self, name: str, gathered) -> dict:
        """A gathered flat buffer as tensors, or a gathered q8 payload as
        ``QuantTensor``s and decodes."""
        lo = self.rt.layouts[name]
        if isinstance(gathered, dict):
            return lo.buffer.unpack_quant(gathered, lo.store.block,
                                          self.compute_dtype)
        return lo.buffer.unpack(gathered)

    def globals(self, group: str) -> dict[str, torch.Tensor]:
        return self._unpack(group, self._gather(group))

    def scan(self, groups, body, carry, xs=None):
        """The FSDP layer loop: for each layer, gather every group's layer
        shard, unpack and run ``body(p, carry, x)`` -> ``(carry, y)``, in
        the structure ``CommSchedule.plan_layers`` resolves (the
        reference's ``scan``):

          * default -- gather, unpack and compute inside one non-reentrant
            activation checkpoint per layer: backward re-gathers (ZeRO-3)
            and only the layer inputs live between forward and backward;
          * prefetch -- one checkpoint per layer pair, whose two gathers
            are both issued (asynchronously on the xla route) before either
            layer's compute; slot 1 is waited for after slot 0's compute,
            so it overlaps it, and no gathered buffer outlives the pair
            body (an odd tail layer runs as in the default);
          * reshard_after_forward=False -- the gathers run outside the
            checkpoint, which takes the gathered buffers as inputs, so they
            are saved into backward while activations are recomputed;
          * keep_last_gathered -- the last layer runs so (gathered outside
            its checkpoint); the rest as above.

        The serve getter runs the same structure with no checkpoint.
        Returns ``(carry, ys)`` (``ys`` None when every ``y`` is None)."""
        n = self.rt.layouts[groups[0]].n_layers
        sched = self.rt.schedule
        remat = not self.serve
        reshard = sched.reshard_after_forward
        lp = sched.plan_layers(n, remat)

        def ckpt(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)

        def start(i):
            return [self._start(g, i) for g in groups]

        def gather(i, started=None):
            started = started or [None] * len(groups)
            return [self._gather(g, i, st) for g, st in zip(groups, started)]

        def compute(gathered, c, i):
            p = {}
            for g, gb in zip(groups, gathered):
                p.update(self._unpack(g, gb))
            return body(p, c, None if xs is None else xs[i])

        # gathered buffers enter the checkpoint as inputs: saved into
        # backward, no re-gather
        inner = ((lambda g, c, i: ckpt(compute, g, c, i))
                 if remat and not reshard else compute)

        def seq(i, c):
            return inner(gather(i), c, i)

        def pair(i, c):
            s0, s1 = start(i), start(i + 1)
            c, y0 = inner(gather(i, s0), c, i)
            c, y1 = inner(gather(i + 1, s1), c, i + 1)
            return c, (y0, y1)

        ys = []
        if lp.prefetch:
            for k in range(lp.pairs):
                if remat and reshard:
                    carry, y2 = ckpt(pair, 2 * k, carry)
                else:
                    carry, y2 = pair(2 * k, carry)
                ys.extend(y2)
            tail = range(2 * lp.pairs, lp.main)
        else:
            tail = range(lp.main)
        for i in tail:
            if remat and reshard:
                carry, y = ckpt(seq, i, carry)
            else:
                carry, y = seq(i, carry)
            ys.append(y)
        if lp.split_last:
            # gathered outside the checkpointed compute: its buffer lives
            # into backward, where it is needed first
            carry, y = ckpt(compute, gather(n - 1), carry, n - 1)
            ys.append(y)
        return carry, (None if all(y is None for y in ys) else ys)


def _row(state, layer: int):
    """Row ``layer`` of every leaf of a stacked group's state."""
    if isinstance(state, dict):
        return {k: v[layer] for k, v in state.items()}
    return state[layer]
