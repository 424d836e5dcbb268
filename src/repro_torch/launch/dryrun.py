"""Dry run at the production mesh: what one rank holds, moves and computes
(port of ``repro/launch/dryrun.py``; no card, no collective moves a byte).

For every (architecture x input shape) pair, one step of rank 0 runs on
meta tensors (shapes and dtypes, no values, no memory) over a process
group of the ``"fake"`` backend of the production world size -- 16 x 16 =
256 ranks, or ``--multi-pod`` 2 x 16 x 16 = 512 (``launch.mesh.
make_production_mesh``) -- through the runtime's own step
(``FSDPRuntime`` on ``device="meta"``; ``launch.specs`` gives its inputs).
A dispatch mode (``StepRecorder``) records:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls and
    attention; ``q8_matmul``'s int8 operations from the kernel ledger);
  * bytes: each op's inputs and outputs, once each (views move none; a
    kernel of ``kernels.ops`` counts as the one op it is on the card, at
    the bytes its bound counts -- its meta branch, ``ops.recording``);
  * the collectives: each c10d op the wire issues, with its kind, its
    group's size and its largest buffer (``launch.roofline``'s volume
    rule), and as the plan verifier's ``CollectiveEvent`` (the
    reference's primitive, the mesh axes its group spans, the payload's
    dtype and elements; ``analysis.trace``);
  * memory: the argument bytes (parameters, optimizer state and the
    optimizer's masks, the batch, the cache) and the peak of the bytes the
    step's own storages hold live beyond them (``temp``): the card's
    ``max_memory_allocated`` of a step is about their sum.  Under a
    dispatch mode autograd takes the out-of-place form of a few backward
    formulas (``gather``'s ``scatter_add``: the cross entropy's), which
    holds one more gradient-sized temporary than the card's in-place form;
    gemma2-2b's 4-layer step peaks there, at (2, 2047, 256000) fp32.
    For the verifier it also keeps the peak count of live storages per
    (elements, dtype) class, each int8/float8 -> fp32 copy and the
    step's output shapes.

``--verify`` proves the plan's declared invariants (``analysis.verify``)
against this same step: one trace, not two.  A train row checks them
all; a prefill or decode step has no reduce, so its row checks the
static ones.  A violation makes the row an error row.

Calibration: the reference compiles a rolled ``lax.scan``, whose body XLA's
``cost_analysis`` counts once, so it compiles 1- and 2-block variants and
extrapolates.  The port's layer loop and microbatches run every layer and
every microbatch, so its counts are whole: ``--no-calibrate`` is accepted
and changes nothing.

PARITY: a class of its own, not the reference's numbers.  XLA's ``flops``
counts elementwise work too and its ``bytes accessed`` is after fusion;
the port counts matmul and attention FLOPs and eager, unfused bytes.  The
plan's wire bytes (``gather_wire_mb``, ``reduce_wire_mb``) and
``model_gflops`` are the reference's (the same planner and formula), and
``--plan-only`` prints the reference's plan text.  A (pair) the port
cannot run is an error row (``ok: false``), never a run on real tensors.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--planner ragged]
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k \\
        --verify                             # and prove the plan's invariants
    python -m repro_torch.launch.dryrun --plan-only --all [--multi-pod]
    python -m repro_torch.launch.dryrun --arch gemma2-2b --mesh 1x1 \\
        --layers 4 --batch 2 --seq 2048      # one card's step, as trained
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..core.policy import dtype_name

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results"

# ops that allocate or alias without reading or writing a byte
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh"}


@dataclasses.dataclass
class StepRecord:
    """What one step of rank 0 did on meta tensors (``StepRecorder``)."""

    flops: float = 0.0           # FlopCounterMode + q8_matmul operations
    bytes: float = 0.0           # op inputs + outputs, kernels at bound
    collectives: list = dataclasses.field(default_factory=list)
    kernels: list = dataclasses.field(default_factory=list)
    arg_bytes: int = 0
    temp_peak: int = 0
    seconds: float = 0.0
    # the plan verifier's view (``analysis.trace``): each collective as a
    # ``CollectiveEvent``, the peak count of live storages per (elements,
    # dtype) class, each int8 or float8 -> float32 conversion (``(src
    # dtype, elements, path)``) and the step's output as shapes
    events: list = dataclasses.field(default_factory=list)
    class_peaks: dict = dataclasses.field(default_factory=dict)
    conversions: list = dataclasses.field(default_factory=list)
    out_shapes: Any = None
    # ``--verify``: the report's counts and the seconds its checks took
    verify: dict | None = None

    @property
    def peak_bytes(self) -> int:
        """Arguments plus the step's peak: the predicted
        ``max_memory_allocated``."""
        return self.arg_bytes + self.temp_peak

    def kernel_calls(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for k in self.kernels:
            out[k["kernel"]] = out.get(k["kernel"], 0) + 1
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


# c10d op -> the reference's collective primitive, and the argument that
# holds its payload (one event per payload tensor)
_PRIMITIVES = {
    "_allgather_base_": ("all_gather", "input_tensor"),
    "allgather_": ("all_gather", "input_tensors"),
    "allgather_into_tensor_coalesced_": ("all_gather", "inputs"),
    "_reduce_scatter_base_": ("psum_scatter", "input_tensor"),
    "reduce_scatter_": ("psum_scatter", "input_tensors"),
    "reduce_scatter_tensor_coalesced_": ("psum_scatter", "inputs"),
    "allreduce_": ("psum", "tensors"),
    "allreduce_coalesced_": ("psum", "tensors"),
    "alltoall_base_": ("all_to_all", "input"),
    "alltoall_": ("all_to_all", "input_tensors"),
    "send": ("ppermute", "tensors"),
}
_CODE_DTYPES = frozenset({torch.int8, torch.float8_e4m3fn, torch.float8_e5m2})


def _trail(depth: int = 8) -> str:
    """The step's Python frames in the port below the dispatch (the dry
    run's and the verifier's own left out), outermost first, as
    ``module.function`` joined by ``/``: an event's ``path``."""
    names = []
    f = sys._getframe(2)
    while f is not None and len(names) < depth:
        co = f.f_code
        if "repro_torch" in co.co_filename and \
                not co.co_filename.endswith("dryrun.py") and \
                "analysis" not in co.co_filename:
            names.append(f"{pathlib.Path(co.co_filename).stem}."
                         f"{co.co_name}")
        f = f.f_back
    return "/".join(reversed(names))


class StepRecorder(TorchDispatchMode):
    """Bytes, collectives and live storage of the ops run inside it (on
    meta tensors).  ``add_args`` registers the step's inputs first: their
    storages count as argument bytes, never as the step's own.
    ``add_mesh`` names each of the mesh's process groups by the axes it
    spans, which each collective's event then carries."""

    def __init__(self, record: StepRecord):
        super().__init__()
        self.record = record
        self._args: set[int] = set()
        self._live_keys: set[int] = set()
        self._live_class: dict[tuple, int] = {}
        # storages of float8 tensors the wire moves as uint8 views
        self._fp8: dict[int, str] = {}
        self._axes: dict[str, tuple[str, ...]] = {}
        self.live = 0

    def add_args(self, *trees) -> None:
        for t in _tensors(trees):
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._args:
                self._args.add(key)
                self.record.arg_bytes += st.nbytes()

    def add_mesh(self, mesh) -> None:
        for axes, g in mesh._groups.items():
            if g is not None:
                self._axes[g.group_name] = tuple(axes)

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args or key in self._live_keys:
            return
        n = st.nbytes()
        self._live_keys.add(key)
        self.live += n
        self.record.temp_peak = max(self.record.temp_peak, self.live)
        cls = (n // t.element_size(), dtype_name(t.dtype))
        count = self._live_class.get(cls, 0) + 1
        self._live_class[cls] = count
        if count > self.record.class_peaks.get(cls, 0):
            self.record.class_peaks[cls] = count
        weakref.finalize(st, self._free, key, n, cls)

    def _free(self, key: int, n: int, cls: tuple) -> None:
        self._live_keys.discard(key)
        self.live -= n
        self._live_class[cls] -= 1
        self._fp8.pop(key, None)

    def _payload_dtype(self, t: torch.Tensor) -> str:
        if t.dtype == torch.uint8:
            name = self._fp8.get(t.untyped_storage()._cdata)
            if name is not None:
                return name
        return dtype_name(t.dtype)

    def _collective(self, func, args, kwargs) -> None:
        from ..analysis.trace import CollectiveEvent
        from .roofline import COLLECTIVE_KINDS

        op = func._schema.name.split("::")[-1]
        kind = COLLECTIVE_KINDS.get(op)
        if kind is None:
            return
        pg, payload = None, None
        prim, arg = _PRIMITIVES.get(op, (op, None))
        for a, v in zip(func._schema.arguments, args):
            if a.name == "process_group":
                pg = torch._C._distributed_c10d.ProcessGroup.unbox(v)
            elif a.name == arg:
                payload = v
        group = pg.size() if pg is not None else 1
        buf = max((_nbytes(t) for t in _tensors((args, kwargs))), default=0)
        self.record.collectives.append((kind, group, buf))
        axes = self._axes.get(pg.group_name, ()) if pg is not None else ()
        path = _trail()
        items = payload if isinstance(payload, (list, tuple)) else [payload]
        for item in items:
            ts = _tensors(item)
            if not ts:
                continue
            self.record.events.append(CollectiveEvent(
                kind=prim, axes=axes, axis_size=group,
                dtype=self._payload_dtype(ts[0]),
                elems=sum(t.numel() for t in ts), trips=1, path=path))

    def _conversion(self, name: str, args, out) -> None:
        """An int8 or float8 tensor converted to float32 outside a kernel
        (``kernels.ops``' calls are opaque here: their meta branch makes
        empty outputs)."""
        if name == "_to_copy":
            src, dst = args[0], out
        else:  # copy_
            dst, src = args[0], args[1]
        if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                and src.dtype in _CODE_DTYPES
                and dst.dtype == torch.float32):
            self.record.conversions.append(
                (dtype_name(src.dtype), dst.numel(), _trail()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args, kwargs)
            return out
        name = func._schema.name.split("::")[-1]
        if name in ("_to_copy", "copy_"):
            self._conversion(name, args, out)
        elif name == "view" and func._overloadname == "dtype" and \
                args[0].dtype in _CODE_DTYPES and args[0].dtype != torch.int8:
            self._fp8[args[0].untyped_storage()._cdata] = \
                dtype_name(args[0].dtype)
        outs = _tensors(out)
        if not func.is_view and name not in _NO_BYTES:
            for side in (_tensors((args, kwargs)), outs):
                self.record.bytes += sum(
                    _nbytes(t) for t in {id(t): t for t in side}.values())
        for t in outs:
            self._track(t)
        return out


def dry_step(cfg, shape, axis_sizes, *, planner: str = "ragged",
             policies=None, cost_model=None, plan=None,
             compute_dtype: torch.dtype = torch.bfloat16, model=None,
             optimizer_cls=None, batch=None):
    """One step of ``shape.kind`` of rank 0 of a fake mesh of
    ``axis_sizes`` on meta tensors: ``(StepRecord, ShardingPlan)``.  The
    runtime takes ``plan`` when given (a twin of another runtime:
    ``analysis.trace``), else resolves one; ``model`` defaults to
    ``build_model(cfg)``, the optimizer to ``make_optimizer(cfg)`` (or
    ``optimizer_cls(cfg)``), and ``batch`` (``{key: (global shape,
    dtype)}``) to ``launch.specs``' batch of ``shape``.  A fake default
    group of the mesh's size is made unless the process has one."""
    from contextlib import nullcontext

    import torch.distributed as dist

    from ..configs import build_model
    from ..core.fsdp import FSDPRuntime
    from .mesh import fake_world, make_fake_mesh

    record = StepRecord()
    t0 = time.perf_counter()
    world = math.prod(axis_sizes.values())
    reuse = (dist.is_initialized() and "fake" in str(dist.get_backend())
             and dist.get_world_size() == world)
    with nullcontext() if reuse else fake_world(world):
        model = build_model(cfg) if model is None else model
        mesh = make_fake_mesh(axis_sizes)
        kw = dict(plan=plan) if plan is not None else dict(
            planner=planner, policies=policies, cost_model=cost_model)
        rt = FSDPRuntime(model, mesh, compute_dtype=compute_dtype,
                         device="meta", **kw)
        plan = rt.plan
        _record_step(rt, model, cfg, shape, record, optimizer_cls, batch)
        del rt
    record.seconds = time.perf_counter() - t0
    return record, plan


def _record_step(rt, model, cfg, shape, record, optimizer_cls=None,
                 batch=None) -> None:
    """Run ``rt``'s step of ``shape.kind`` under a ``StepRecorder`` into
    ``record`` (its output's shapes kept as ``record.out_shapes``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..analysis.trace import leaf_specs
    from ..kernels import ops
    from ..optim import make_optimizer
    from .specs import input_specs

    held = {}
    if shape.kind == "train":
        optimizer = (make_optimizer(cfg) if optimizer_cls is None
                     else optimizer_cls(cfg))
        args = input_specs(cfg, shape, rt, model, optimizer)
        if batch is not None:
            lo, hi = rt.batch_slice(shape.global_batch)
            args = args[:3] + ({
                k: torch.empty((hi - lo,) + tuple(s[1:]), dtype=dt,
                               device="meta")
                for k, (s, dt) in batch.items()},)
        held = optimizer.held_tensors()
        step = rt.make_train_step(optimizer)
    else:
        args = input_specs(cfg, shape, rt, model)
        step = (rt.make_prefill_step() if shape.kind == "prefill"
                else rt.make_decode_step())
    recorder = StepRecorder(record)
    recorder.add_args(args, held)
    recorder.add_mesh(rt.mesh)
    flops = FlopCounterMode(display=False)
    with ops.recording(record.kernels), flops, recorder:
        out = step(*args)
    record.out_shapes = leaf_specs(out)
    del out
    record.flops = float(flops.get_total_flops()) + sum(
        k["flops"] for k in record.kernels)
    record.bytes += sum(k["bytes"] for k in record.kernels)


def _mesh_name(axis_sizes) -> str:
    """The reference's production names, else the sizes joined by x."""
    sizes = tuple(axis_sizes.values())
    if sizes == (16, 16):
        return "pod16x16"
    if sizes == (2, 16, 16):
        return "pod2x16x16"
    return "x".join(map(str, sizes))


def run_one(arch: str, shape_name, *, multi_pod: bool = False,
            planner: str = "ragged", quiet: bool = False,
            calibrate: bool = True, overrides: dict | None = None,
            policies=None, cost_model=None, verify: bool = False,
            axis_sizes: dict | None = None, record: list | None = None):
    """The ``Roofline`` of one (arch, shape) pair at the production mesh
    (``axis_sizes`` another mesh; ``shape_name`` a ``SHAPES`` key or a
    ``ShapeConfig``).  ``overrides``: config fields (``"parallel"`` a dict
    of ``ParallelConfig`` fields).  ``calibrate`` changes nothing (the
    module docstring); ``record``, a list, receives the ``StepRecord``."""
    from ..configs import build_model, get_config, supports_shape
    from ..configs.base import SHAPES, ShapeConfig
    from ..core.policy import plan as make_plan
    from .mesh import production_axis_sizes
    from .roofline import Roofline, analyze

    del calibrate
    cfg = get_config(arch)
    if overrides:
        par = dataclasses.replace(cfg.parallel,
                                  **overrides.get("parallel", {}))
        cfg = dataclasses.replace(
            cfg, parallel=par,
            **{k: v for k, v in overrides.items() if k != "parallel"})
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else SHAPES[shape_name]
    axis_sizes = dict(axis_sizes or production_axis_sizes(
        multi_pod=multi_pod))
    mesh_name = _mesh_name(axis_sizes)
    chips = math.prod(axis_sizes.values())

    ok, why = supports_shape(cfg, shape)
    if not ok:
        return Roofline(arch=arch, shape=shape.name, mesh=mesh_name,
                        chips=chips, compile_ok=False, note=f"SKIP: {why}")
    if policies == "auto":
        # resolve the cost model once, on the host, and pin its per-group
        # decisions as an explicit PolicySet (the reference's order)
        auto = make_plan(build_model(cfg), axis_sizes, "auto",
                         cost_model=cost_model)
        if not quiet:
            print(auto.describe())
        policies = auto.policy_set()
    rec, plan = dry_step(cfg, shape, axis_sizes, planner=planner,
                         policies=policies, cost_model=cost_model)
    if record is not None:
        record.append(rec)
    if verify:
        _verify(rec, plan, shape, axis_sizes, quiet)
    if not quiet:
        print(plan.describe())
        print({"flops": rec.flops, "bytes accessed": rec.bytes,
               "argument_bytes": rec.arg_bytes, "temp_peak": rec.temp_peak,
               "kernel_calls": rec.kernel_calls()})
    return analyze(rec, arch=arch, shape_cfg=shape, mesh_name=mesh_name,
                   chips=chips, cfg=cfg, plan=plan,
                   note=(why + f" dry_run={rec.seconds:.1f}s").strip())


def _verify(rec: StepRecord, plan, shape, axis_sizes, quiet: bool) -> None:
    """``--verify``: the plan's declared invariants proved against this
    very step (``analysis.verify``; one trace, not two).  A train step
    proves every invariant; a serve step has no reduce, so its report
    holds the static checks only.  Raises ``VerificationError`` on a
    violation; the counts go into ``rec.verify``."""
    from ..analysis.trace import from_record
    from ..analysis.verify import verify_plan_static, verify_trace

    t0 = time.perf_counter()
    report = verify_plan_static(plan)
    if shape.kind == "train":
        tr = from_record(rec, axis_sizes)
        report = report.merged(verify_trace(plan, tr.comm, tr.buffers,
                                            tr.out_shapes))
    rec.verify = {"checked": len(report.checked),
                  "errors": len(report.errors),
                  "warnings": len(report.warnings),
                  "seconds": time.perf_counter() - t0}
    if not quiet:
        print(report.summary())
    report.raise_if_failed()


def plan_only(arch: str, *, multi_pod: bool = False, planner: str = "ragged",
              policies=None, cost_model=None) -> str:
    """Resolve and print the ShardingPlan without running a step: planning
    is host metadata over the production mesh's axis sizes (no process
    group).  With the default (legacy) policies it also cross-checks the
    lowering: the plan of the config's flat knobs must be JSON-identical
    to the plan of the explicitly spelled PolicySet.  The reference's text
    line for line."""
    from ..configs import build_model, get_config
    from ..core.policy import PolicySet, plan as make_plan
    from .mesh import production_axis_sizes

    cfg = get_config(arch)
    axes = production_axis_sizes(multi_pod=multi_pod)
    model = build_model(cfg)
    p = make_plan(model, axes, policies, planner=planner,
                  cost_model=cost_model)
    out = [p.describe()]
    if policies is None:
        explicit = PolicySet.from_parallel_config(cfg.parallel)
        p2 = make_plan(model, axes, explicit, planner=planner)
        if p.dumps() != p2.dumps():
            raise AssertionError(
                "legacy-config lowering diverged from the explicit "
                f"PolicySet spelling: {p.diff(p2)}")
        out.append("plan lowering parity OK (legacy knobs == PolicySet)")
    return "\n".join(out)


def append_result(row: dict, path: pathlib.Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")


# beyond-paper optimized profile (the reference's): smaller online-softmax
# tiles, vocab-chunked CE, tight MoE capacity, tuned microbatches
OPTIMIZED = {"attn_chunk": 512, "ce_chunk": 8192, "capacity_factor": 1.0}
OPTIMIZED_PARALLEL = {"nemotron-4-340b": {"microbatches": 4}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--planner", default="ragged")
    ap.add_argument("--policies", default=None,
                    help="'auto' picks per-group store/comm policies from "
                         "the structure-aware cost model (core.policy); "
                         "default lowers the config's legacy knobs")
    ap.add_argument("--plan-only", action="store_true",
                    help="resolve + print the ShardingPlan (and check "
                         "legacy-lowering parity); no step")
    ap.add_argument("--profile", default=None,
                    help="measured comm profile JSON (launch.bench_comm); "
                         "prices --policies auto from its curves instead of "
                         "the builtin roofline constants")
    ap.add_argument("--verify", action="store_true",
                    help="prove the plan's invariants against the traced "
                         "step (the same meta step the row records)")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="accepted for the reference's command lines; the "
                         "port's counts need no calibration")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the beyond-paper winners (attn_chunk=512, "
                         "ce_chunk=8192, capacity 1.0)")
    ap.add_argument("--out", default=str(RESULTS / "dryrun_torch.jsonl"))
    # the port's own: another mesh, depth and train shape
    ap.add_argument("--mesh", default=None,
                    help="axis sizes DxM or PxDxM (pod, data, model) in "
                         "place of the production mesh")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers (an "
                         "encoder-decoder's two stacks each; a VLM's "
                         "depth a multiple of its cross_attn_interval)")
    ap.add_argument("--batch", type=int, default=None,
                    help="with --seq: a train shape of this global batch "
                         "in place of --shape")
    ap.add_argument("--seq", type=int, default=None)
    return ap.parse_args(argv)


def _axis_sizes(spec: str | None):
    if spec is None:
        return None
    sizes = [int(x) for x in spec.lower().split("x")]
    names = ("pod", "data", "model")[-len(sizes):] if len(sizes) in (2, 3) \
        else None
    if names is None:
        raise ValueError(f"--mesh takes DxM or PxDxM, got {spec!r}")
    return dict(zip(names, sizes))


def _depth(arch: str, layers: int) -> dict:
    """The config fields ``--layers`` sets: ``n_layers``, and an
    encoder-decoder's ``encoder_layers`` too (the reference's
    ``_with_blocks`` cuts both stacks alike); a VLM depth that is not a
    multiple of its interval raises in ``DecoderLM`` (an error row)."""
    from ..configs import get_config

    if get_config(arch).arch_type == "audio":
        return {"n_layers": layers, "encoder_layers": layers}
    return {"n_layers": layers}


def main(argv=None) -> list[dict]:
    """The command; returns the rows it printed."""
    args = parse_args(argv)
    from ..configs import ASSIGNED_ARCH_IDS
    from ..configs.base import SHAPES, ShapeConfig

    cost_model = None
    if args.profile:
        from ..core.policy import CostModel

        cost_model = CostModel.from_profile(args.profile)

    if args.plan_only:
        archs = ASSIGNED_ARCH_IDS if args.all else [args.arch]
        for arch in archs:
            print(f"== {arch} ==")
            try:
                print(plan_only(arch, multi_pod=args.multi_pod,
                                planner=args.planner, policies=args.policies,
                                cost_model=cost_model))
            except NotImplementedError as e:
                # a family the port lacks: its error line, then the next
                print(f"ERROR {type(e).__name__}: {e}")
        return []

    axis_sizes = _axis_sizes(args.mesh)
    if args.batch is not None or args.seq is not None:
        if args.batch is None or args.seq is None or args.all:
            raise ValueError("--batch and --seq go together, without --all")
        shapes = [ShapeConfig(f"train_b{args.batch}_s{args.seq}", args.seq,
                              args.batch, "train")]
    else:
        shapes = list(SHAPES) if args.all else [args.shape]
    archs = ASSIGNED_ARCH_IDS if args.all else [args.arch]
    out = pathlib.Path(args.out)
    rows = []
    for arch in archs:
        for shape in shapes:
            name = shape.name if isinstance(shape, ShapeConfig) else shape
            rec: list = []
            try:
                ov = dict(OPTIMIZED) if args.optimized else {}
                if args.optimized and arch in OPTIMIZED_PARALLEL:
                    ov["parallel"] = OPTIMIZED_PARALLEL[arch]
                if args.layers is not None:
                    ov.update(_depth(arch, args.layers))
                r = run_one(arch, shape, multi_pod=args.multi_pod,
                            planner=args.planner,
                            calibrate=not args.no_calibrate,
                            overrides=ov or None, policies=args.policies,
                            cost_model=cost_model, verify=args.verify,
                            axis_sizes=axis_sizes, record=rec)
                row = r.row()
            except Exception as e:
                traceback.print_exc()
                row = {"arch": arch, "shape": name,
                       "mesh": "pod2x16x16" if args.multi_pod
                       else "pod16x16" if axis_sizes is None
                       else _mesh_name(axis_sizes),
                       "ok": False, "note": f"ERROR {type(e).__name__}: {e}"}
            row["planner"] = args.planner
            row["policies"] = args.policies or "legacy"
            row["profile"] = "optimized" if args.optimized else "baseline"
            if rec:
                row["kernel_calls"] = rec[0].kernel_calls()
                row["peak_bytes_dev"] = rec[0].peak_bytes
                row["arg_bytes_dev"] = rec[0].arg_bytes
                if rec[0].verify is not None:
                    row["verify"] = rec[0].verify
            print(json.dumps(row), flush=True)
            append_result(row, out)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
