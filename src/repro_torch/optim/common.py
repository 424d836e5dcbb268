"""Optimizer base utilities on flat DBuffer shards (port of
``repro/optim/common.py``).

Optimizers run on the rank-local slice of each group buffer, so every
update is one group-fused elementwise pass.  Per-tensor behaviour (weight
decay only on matrices, Muon only on 2-D parameters) is recovered from the
static plan as a position mask; the mask never changes, so it is built
once per group and rank on the host from the plan's placements and kept on
the device as one ``(S,)`` row that every layer row of a stacked group
shares.

The fused AdamW and 8-bit Adam updates are kernels.  SGD, Muon and Shampoo
are PyTorch tensor code, as their reference is jnp code: they read the fp32
weights through ``ParamStore.master_f32``, run their elementwise chain over
column chunks of the flat shard (``pieces``) in the reference's operation
order, so no group-sized fp32 intermediate is ever materialized, and write
the store's leaves back through ``ParamStore.rebuild``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

# elements of one column chunk of the elementwise passes (64 MiB in fp32)
CHUNK = 1 << 24


def device_linear_index(runtime, layout) -> int:
    """This rank's shard index within the group's FSDP axes (0..m-1): the
    axes' indices in row-major order, as the reference's traced
    ``device_linear_index``."""
    idx = 0
    for a, size in zip(layout.fsdp_axes, layout.fsdp_axis_sizes):
        idx = idx * size + runtime._axis_index(a)
    return idx


def fsdp_world(layout) -> int:
    """m, the number of shards of the group (1 for an unsharded one)."""
    return math.prod(layout.fsdp_axis_sizes) or 1


def matrix_mask_local(layout, rank: int) -> np.ndarray:
    """(S,) fp32 0/1 mask of rank ``rank``'s shard of ``layout``'s group:
    1 where the flat position belongs to a >=2-D tensor (weight-decay
    eligible).  Host int64 arithmetic, so multi-billion-element groups need
    no blocked coordinates.  PARITY: BITWISE vs the reference's traced
    ``matrix_mask_local`` (one of its layer rows)."""
    S = layout.plan.shard_size
    lo, hi = rank * S, (rank + 1) * S
    mask = np.zeros(S, np.float32)
    for pl in layout.plan.placements:
        if len(pl.spec.shape) >= 2:
            a, b = max(pl.offset, lo), min(pl.end, hi)
            if a < b:
                mask[a - lo:b - lo] = 1.0
    return mask


def mask_rows(runtime) -> dict[str, torch.Tensor]:
    """Each group's ``matrix_mask_local`` row for this rank as uint8 on the
    runtime's device: one byte an element of the shard, broadcast over the
    layer axis (its fp32 values are 0 and 1 exactly, so a chunk's
    ``.float()`` is the reference's mask)."""
    return {name: torch.from_numpy(matrix_mask_local(
        lo, device_linear_index(runtime, lo)).astype(np.uint8))
        .to(runtime.device) for name, lo in runtime.layouts.items()}


def store_outputs(store, pstate, buf) -> tuple:
    """The store's leaves a fused update writes in place, in its ``out``
    order: the codes (and q8 scales) beside the master, or the flat buffer
    alone."""
    if store.quantized:
        return (pstate["codes"], buf, pstate["scales"])
    if store.fp8:
        return (pstate["codes"], buf)
    return (buf,)


def pieces(*tensors: torch.Tensor | None, chunk: int = CHUNK):
    """Walk tensors shaped like one group's buffer (``(L, S)`` or ``(S,)``)
    in column chunks, row by row: yields ``((lo, hi), views)``, the chunk's
    columns and each tensor's view of them (None stays None).  An
    elementwise chain over the views touches every element once, and its
    temporaries are chunk-sized."""
    flat = [None if t is None else t.view(-1, t.shape[-1]) for t in tensors]
    rows, S = next(t for t in flat if t is not None).shape
    for r in range(rows):
        for lo in range(0, S, chunk):
            hi = min(lo + chunk, S)
            yield (lo, hi), tuple(None if t is None else t[r, lo:hi]
                                  for t in flat)


def grad_f32(g: torch.Tensor, grad_scale) -> torch.Tensor:
    """The reference's ``(g * scale).astype(float32)`` of (a chunk of) one
    group's gradient: the train step scales fp32 gradients in place; a
    bf16 gradient is cast and scaled here.  The reference's ``g * scale``
    multiplies a bf16 array by an fp32 scalar, which promotes to fp32, so
    this is its order: cast first, then one fp32 product.  PARITY:
    BITWISE."""
    if g.dtype == torch.float32:
        return g
    g = g.float()
    return g if grad_scale is None else g.mul_(grad_scale)


def adam_direction(g, m, v, *, b1, a1, b2, a2, eps, c1, c2):
    """In place on (chunks of) the moments, ``m' = b1 m + a1 g`` and ``v'
    = b2 v + a2 g g``; returns the bias-corrected Adam direction ``(m' /
    c1) / (sqrt(v' / c2) + eps)`` -- the Adam fallback of Muon and
    Shampoo, each product rounded on its own (XLA may contract one with
    its sum into an FMA)."""
    m.mul_(b1).add_(a1 * g)
    v.mul_(b2).add_(a2 * g * g)
    return (m / c1) / (torch.sqrt(v / c2) + eps)


def write_decayed(store, w_c, upd, mk, lr: float, wd: float) -> None:
    """``w' = w - lr (upd + wd mask w)`` into (a chunk of) a store's
    trainable buffer, through its fp32 view (``ParamStore.master_f32``)."""
    w = store.master_f32(w_c)
    w.sub_(lr * (upd + wd * mk * w))
    if w is not w_c:
        w_c.copy_(w)


def gather_cols(t: torch.Tensor, runtime, m: int) -> torch.Tensor:
    """All-gather a rank-local ``(L, S)`` shard along its last axis into
    the group's ``(L, m * S)`` buffer (the reference's ``all_gather(...,
    axis=1, tiled=True)``).  The collective stacks the ranks' shards along
    the first axis, ``(m, L, S)``; the permute puts each rank's columns
    back beside the others' (a reshape alone would not)."""
    if m == 1:
        return t
    L, S = t.shape
    out = torch.empty((m * L, S), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=runtime.group)
    return out.view(m, L, S).permute(1, 0, 2).reshape(L, m * S)


def gather_rows(t: torch.Tensor, runtime, m: int) -> torch.Tensor:
    """All-gather along the leading axis: ``(l, ...)`` per rank ->
    ``(m * l, ...)`` in rank order (``all_gather(..., axis=0,
    tiled=True)``)."""
    if m == 1:
        return t
    out = torch.empty((m * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=runtime.group)
    return out


def my_layers(mats: torch.Tensor, dev: int, l_loc: int) -> torch.Tensor:
    """Rows ``[dev * l_loc, (dev + 1) * l_loc)`` of ``mats`` (L, a, b)
    zero-padded to ``Lp = m * l_loc`` rows: the whole matrices this rank
    owns under the layer-axis redistribution (the reference pads L and
    takes a ``dynamic_slice``).  Always a fresh fp32 tensor."""
    L = mats.shape[0]
    lo, hi = min(dev * l_loc, L), min((dev + 1) * l_loc, L)
    out = torch.zeros((l_loc,) + tuple(mats.shape[1:]), dtype=torch.float32,
                      device=mats.device)
    out[:hi - lo] = mats[lo:hi]
    return out


def redistribute(runtime, layout, x: torch.Tensor, per_matrix
                 ) -> torch.Tensor:
    """The layer-axis redistribution of one stacked group (paper section
    6.3): ``x``, this rank's ``(L, S)`` shard, is all-gathered along the
    shard axis into the group's ``(L, m * S)`` buffer; for every 2-D
    placement this rank takes its ``ceil(L / m)`` whole matrices (L padded
    to a multiple of m) and ``per_matrix(placement, mine)`` maps them,
    ``(l_loc, a, b)`` fp32, to their update of the same shape; the updates
    are all-gathered along the layer axis and scattered into the flat
    buffer.  Returns this rank's ``(L, S)`` shard of it (zeros at the
    positions no 2-D placement covers)."""
    L, S = x.shape
    m = fsdp_world(layout)
    dev = device_linear_index(runtime, layout)
    full = gather_cols(x, runtime, m)                 # (L, m * S)
    upd_full = torch.zeros_like(full)
    l_loc = -(-L // m)
    for pl in layout.plan.placements:
        if len(pl.spec.shape) != 2:
            continue
        a, b = pl.spec.shape
        mine = my_layers(full[:, pl.offset:pl.end].reshape(L, a, b), dev,
                         l_loc)
        o = gather_rows(per_matrix(pl, mine), runtime, m)   # (Lp, a, b)
        upd_full[:, pl.offset:pl.end] = o[:L].reshape(L, a * b)
        del mine, o
    return upd_full[:, dev * S:(dev + 1) * S]


def has_matrices(layout) -> bool:
    """A stacked group with a 2-D placement: the groups Muon and Shampoo
    precondition (every other group takes their Adam fallback)."""
    return layout.n_layers is not None and any(
        len(pl.spec.shape) == 2 for pl in layout.plan.placements)


class OptimizerBase:
    def __init__(self, cfg):
        self.cfg = cfg
        self.lr = cfg.learning_rate

    def schedule(self, step: int) -> np.float32:
        """Linear warmup over 100 steps, in float32 on the host from the
        Python step counter (the reference's ``schedule`` on a traced
        int32 step)."""
        warmup = np.float32(100.0)
        return np.float32(self.lr) * np.minimum(
            (np.float32(step) + np.float32(1.0)) / warmup, np.float32(1.0))

    def host_scalars(self, step: int):
        """(lr, c1, c2) in float32 for 0-based ``step`` of an Adam-family
        optimizer: the warmup rate and the bias corrections ``1 - b**(step
        + 1)`` for the class's ``b1``, ``b2``."""
        lr = self.schedule(step)
        t = np.float32(step) + np.float32(1.0)
        c1 = np.float32(1.0) - np.float32(self.b1) ** t
        c2 = np.float32(1.0) - np.float32(self.b2) ** t
        return lr, c1, c2

    def state_leaves(self) -> dict[str, tuple[torch.dtype, int]]:
        """The state's per-group leaves, ``{key: (dtype, div)}``: per group
        a tensor of the group's shape with the last axis divided by ``div``
        (one entry per quant block of ``div`` elements)."""
        raise NotImplementedError

    def extra_leaves(self, runtime) -> dict[str, dict[str, tuple]]:
        """Leaves not shaped like a group's buffer, ``{key: {leaf: (dtype,
        global shape, sharded axis)}}`` (Shampoo's Kronecker factors);
        none by default."""
        return {}

    def state_layout(self, runtime) -> dict[str, dict[str, tuple]]:
        """Every leaf as ``(dtype, global shape, sharded axis)``: the
        per-group ``state_leaves`` (sharded on the last axis; an unsharded
        group's axis is None), then the ``extra_leaves``.  Each rank holds
        its equal share of the sharded axis, and the whole of a leaf whose
        axis is None."""
        out = {}
        for k, (dtype, div) in self.state_leaves().items():
            out[k] = {}
            for name, lo in runtime.layouts.items():
                shape = lo.global_shape()
                out[k][name] = (dtype, shape[:-1] + (shape[-1] // div,),
                                -1 if lo.fsdp_axes or lo.outer_size > 1
                                else None)
        out.update(self.extra_leaves(runtime))
        return out

    def state_shapes(self, runtime) -> dict[str, dict[str, tuple]]:
        """``{key: {leaf: (dtype, shape)}}`` of the state at the
        rank-local shapes: a group's leaf holds this rank's column block
        (an outer row's FSDP shard), any other sharded leaf an equal share
        per rank of the process group."""
        world = dist.get_world_size(runtime.group)
        out = {}
        for k, leaves in self.state_layout(runtime).items():
            out[k] = {}
            for name, (dtype, shape, axis) in leaves.items():
                shape = list(shape)
                if axis is not None:
                    lo = runtime.layouts.get(name)
                    shape[axis] //= world if lo is None else \
                        lo.outer_size * (fsdp_world(lo) if lo.sharded
                                         else 1)
                out[k][name] = (dtype, tuple(shape))
        return out

    def check_no_outer(self, runtime) -> None:
        """Raise for a runtime whose groups are split over the model axis:
        this optimizer's model-axis layout is not ported (its
        preconditioners and state would see one outer row's part of each
        matrix, as the reference's do)."""
        if any(lo.outer_size > 1 for lo in runtime.layouts.values()):
            raise NotImplementedError(
                f"{type(self).__name__} on groups split over the model axis "
                f"(tensor or expert parallelism) is not ported yet (ROADMAP "
                f"Queue 1 item 19)")

    def zero_state(self, runtime) -> dict[str, dict[str, torch.Tensor]]:
        """Every leaf of the state, zero, on the runtime's device."""
        return {k: {name: torch.zeros(shape, dtype=dtype,
                                      device=runtime.device)
                    for name, (dtype, shape) in leaves.items()}
                for k, leaves in self.state_shapes(runtime).items()}

    def init(self, runtime):
        raise NotImplementedError
