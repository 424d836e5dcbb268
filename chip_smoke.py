"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line per result (any failure exits
non-zero):

  1. device    -- a CUDA card must be present; TF32 is switched off so fp32
                  matmuls are full fp32.
  2. build     -- nvcc builds every kernel of the paths from ``csrc/``.
  3. kernel    -- ``adamw_store_update``'s flat epilogue against its plain
                  PyTorch version on the card at the fp32 train step's group
                  shapes (layers (4, 77865984), globals (589826304,)) and a
                  ragged length, fp32 and bf16 epilogues: integer-view
                  difference (expected 0, the kernel is bitwise), CUDA-event
                  times (median of 20 after warm-up) and the memory bound.
  4. kernel_q8 -- the block-wise INT8 kernels (quantize, dequantize_into,
                  encode_ef, the q8 epilogue of adamw_store_update) against
                  their plain versions at the q8 plan's shard shapes (layers
                  (77869056,) per layer, globals (589826048 + 1024,)) and a
                  block-64 case, fp32 and bf16 where a kernel takes both:
                  integer-view difference (expected 0), median times, bound.
  5. kernel_adam8 -- the fused 8-bit Adam kernel (``adam8bit_store_update``:
                  fp32 and bf16 epilogues, and the q8_block epilogue)
                  against its plain version at qwen3-moe's ``layers`` shard
                  (1, 71835648), the first 536870912 elements of its
                  ``layers_experts`` shard, the reduced config's block-64
                  shard (2, 1572864), a misaligned view, and (q8_block) the
                  gemma2-2b adam8bit q8 plan's shards: integer-view
                  difference (expected 0), median times, bound; then the
                  kernel alone at the full ``layers_experts`` and
                  ``globals`` shards, where the plain version does not fit.
  6. train     -- the fp32 path: gemma2-2b at published width cut to 4
                  layers (two local/global pairs), ZeRO-3 train step through
                  a one-rank NCCL group, bf16 compute, fp32 store, AdamW,
                  batch 2 x 2048 tokens; one warm-up step and three timed
                  steps.  The flat kernel must launch once per group per
                  step (8 times).
  7. train_q8  -- the q8 path: the same model and batch with the q8_block
                  store and the q8 gradient wire with error feedback on both
                  groups (``q8_both_wires``).  Every q8 kernel must launch as
                  often as the gathers, reduce-scatters and groups imply.
  8. train_moe -- the 8-bit Adam path: qwen3-moe-235b-a22b at published
                  width (d_model 4096, 64/4 heads, 128 experts top-8, d_ff
                  1536, vocab 151936) cut to 1 layer, ep=1, one NCCL rank,
                  bf16 compute, fp32 store, Adam8bit, batch 1 x 2048; one
                  warm-up and three timed steps.  The shards must be the
                  plan's, the 8-bit Adam kernel must launch once per group
                  per step and no other kernel at all.
  9. train_adam8_q8 -- gemma2-2b as in ``train`` with Adam8bit on the
                  q8_block store: the q8 epilogue once per group per step,
                  quantize at init, dequantize_into once per gather.
 10. parity    -- gemma2-2b.reduced() (fp32 store and ``q8_both_wires``) and
                  qwen3-moe-235b-a22b.reduced() (``parity_moe``: Adam8bit on
                  the fp32 and q8_block stores), fp32 compute, two steps
                  from the same init and batches of each of four seeds on
                  the CPU (plain versions) and on the card (kernels):
                  losses and grad norms must agree within PARITY_RTOL
                  (PARITY_Q8_RTOL on a q8_block store).

Then the ``kernels`` line, the card's name and power limit as nvidia-smi
reports them, and a last line ``{"ok": true, "device": {...}}``.  The
script imports only the port (never JAX or the JAX package).
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA's H100 SXM data sheet: HBM3 at 3.35 TB/s; fp32 outside the
# tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
LAYERS_SHAPE = (4, 77_865_984)
GLOBALS_SHAPE = (589_826_304,)
RAGGED_SHAPE = (1_000_003,)
# bytes per element: w, g, m, v, mask read (20 B); w' (4 or 2 B), m', v' out
BYTES_PER_ELEM = {"fp32": 32, "bf16": 30}
# fp32 operations per element of the AdamW chain (kernels/ref.py)
FLOPS_PER_ELEM = 16
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 2, 2048
TIMED_STEPS = 3
# card vs CPU, two fp32 steps of a reduced config from each of
# PARITY_SEEDS: limits about four times the largest relative difference of
# loss and grad norm measured over these seeds on the card (readings in
# PERF.md): 6.9e-7 on the fp32 store, 1.7e-6 on the q8_block store
PARITY_SEEDS = (0, 1, 2, 3)
PARITY_RTOL = 3e-6
PARITY_Q8_RTOL = 7e-6
Q8_SCHEDULE = {"param_store": "q8_block", "reduce_wire": "q8_block"}
Q8_ITERS = 10
# fp32 operations per element (beside the bytes they are far from binding)
Q8_FLOPS = {"quantize": 6, "dequantize_into": 1, "encode_ef": 9,
            "adamw_q8": FLOPS_PER_ELEM + 6}
# 8-bit Adam: bytes per element (w, g, m8, v8 in; w', m8', v8' out, plus
# the q8 code of w'), per quant block (ms, vs in and out, plus the weight
# scale) and, once per call, the (S,) uint8 decay row every row shares;
# fp32 operations per element (the AdamW chain, two decodes, two
# requantizes, one expf and one logf)
ADAM8_BYTES = {"fp32": 16, "bf16": 12, "q8_block": 17}
ADAM8_BLOCK_BYTES = {"fp32": 16, "bf16": 16, "q8_block": 20}
ADAM8_FLOPS = {"fp32": 40, "bf16": 40, "q8_block": 46}
MOE = "qwen3-moe-235b-a22b"
MOE_LAYERS, MOE_BATCH, MOE_SEQ = 1, 1, 2048
MOE_SHARDS = {"layers": 71_835_648, "layers_experts": 2_415_919_104,
              "globals": 1_244_663_808}
MOE_SLICE = 536_870_912   # the part of the layers_experts shard compared
ADAM8_Q8_SCHEDULE = {"param_store": "q8_block"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def int_view_diff(a, b) -> int:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return 1 << 62
    if a.numel() == 0:
        return 0
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int8: torch.int8}[a.dtype]
    return int((a.view(view).long() - b.view(view).long()).abs().max())


def flat_outputs(out) -> list:
    """The tensors of a kernel's result, in order (dicts by key)."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat_outputs(o)]
    return [out]


def hold(name: str, case: dict, run_kernel, run_plain, bytes_moved: float,
         flops: float, iters: int = Q8_ITERS, phase: str = "kernel_q8"
         ) -> dict:
    """One kernel against its plain version on the same inputs: integer-view
    difference (must be 0), max abs error, median times, bound."""
    import torch

    got, want = flat_outputs(run_kernel()), flat_outputs(run_plain())
    torch.cuda.synchronize()
    diff = max(int_view_diff(a, b) for a, b in zip(got, want))
    abs_err = max(float((a.float() - b.float()).abs().max()) if a.numel()
                  else 0.0 for a, b in zip(got, want))
    del got, want
    ms = median_ms(run_kernel, iters)
    plain_ms = median_ms(run_plain, iters)
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    row = {"phase": phase, "name": name, **case,
           "max_int_view_diff": diff, "max_abs_err": abs_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S
           >= flops / FP32_FLOPS else "operations",
           "bytes": bytes_moved, "achieved_GBps": bytes_moved / ms / 1e6,
           "parity": "bitwise" if diff == 0 else "DIFFERS"}
    emit(row)
    if diff != 0:
        fail(f"{name} differs from its plain version at {case}: {diff} "
             f"integer-view steps")
    torch.cuda.empty_cache()
    return row


def phase_kernel(fused_update, ref) -> dict:
    """Kernel vs plain at the main path's shapes; returns the summary the
    kernels line carries (the train step's two group updates, fp32)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    scalars = ref.scalar_stack(3e-4, 0.9, 0.95, 1e-8, 0.1,
                               1 - 0.9 ** 3, 1 - 0.95 ** 3)
    worst_abs = 0.0
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for shape in (LAYERS_SHAPE, GLOBALS_SHAPE, RAGGED_SHAPE):
        def rnd(scale):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        w, g, m = rnd(0.05), rnd(1e-3), rnd(1e-4)
        v = rnd(1e-4).square_()
        mask = (torch.rand(shape, generator=gen, device="cuda") < 0.8).float()
        n = w.numel()
        for fmt in ("fp32", "bf16"):
            out = fused_update.adamw_store_update(w, g, m, v, mask, scalars,
                                                  fmt=fmt)
            want = ref.adamw_store_update_ref(w, g, m, v, mask, scalars, fmt)
            torch.cuda.synchronize()
            diff = max(int_view_diff(a, b) for a, b in zip(out, want))
            abs_err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(out, want))
            del want
            ms = median_ms(lambda: fused_update.adamw_store_update(
                w, g, m, v, mask, scalars, fmt=fmt, out=out))
            del out
            plain_ms = median_ms(lambda: ref.adamw_store_update_ref(
                w, g, m, v, mask, scalars, fmt))
            bytes_moved = BYTES_PER_ELEM[fmt] * n
            bound_ms = max(bytes_moved / HBM_BYTES_PER_S,
                           FLOPS_PER_ELEM * n / FP32_FLOPS) * 1e3
            row = {"phase": "kernel", "name": "adamw_store_update",
                   "shape": list(shape), "fmt": fmt,
                   "max_int_view_diff": diff, "max_abs_err": abs_err,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bytes": bytes_moved,
                   "achieved_GBps": bytes_moved / ms / 1e6,
                   "parity": "bitwise" if diff == 0 else "DIFFERS"}
            emit(row)
            if diff != 0:
                fail(f"kernel differs from the plain version at {shape} "
                     f"{fmt}: {diff} integer-view steps")
            worst_abs = max(worst_abs, abs_err)
            if fmt == "fp32" and shape in (LAYERS_SHAPE, GLOBALS_SHAPE):
                step["ms"] += ms
                step["plain_ms"] += plain_ms
                step["bound_ms"] += bound_ms
        del w, g, m, v, mask
        torch.cuda.empty_cache()
    step["max_abs_err"] = worst_abs
    return step


def phase_kernel_q8(ops, ref, layer_shard: int, globals_shard: int) -> dict:
    """The q8 kernels at the q8 plan's shard shapes (one rank: a layer's
    gathered buffer is its shard).  Returns per kernel the summary the
    kernels line carries: one call at each group's main-path shape, summed
    (init quantize of both groups, a bf16 gather and a bf16-cotangent
    encode of each group, the update of each group)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    scalars = ref.scalar_stack(3e-4, 0.9, 0.95, 1e-8, 0.1,
                               1 - 0.9 ** 3, 1 - 0.95 ** 3)
    kw = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=1 - 0.9 ** 3,
              c2=1 - 0.95 ** 3)
    L = TRAIN_LAYERS
    reduced_layer = (2, 64 * 10256)   # gemma2-2b.reduced()'s q8 layer shard
    summary = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0} for k in Q8_FLOPS}

    def rnd(shape, scale=1.0, dtype=torch.float32):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        x.view(-1)[:1024] = 0.0   # an all-zero quant block
        return x.to(dtype)

    def add(key, row, on_path):
        s = summary[key]
        s["max_abs_err"] = max(s["max_abs_err"], row["max_abs_err"])
        if on_path:
            for k in ("ms", "plain_ms", "bound_ms"):
                s[k] += row[k]

    # quantize: the store's init (fp32 masters), a bf16 input, block 64
    for shape, dtype, block, on_path in (
            ((L, layer_shard), torch.float32, 1024, True),
            ((globals_shard,), torch.float32, 1024, True),
            ((layer_shard,), torch.bfloat16, 1024, False),
            (reduced_layer, torch.float32, 64, False)):
        x = rnd(shape, 0.05, dtype)
        n = x.numel()
        row = hold("quantize", {"shape": list(shape), "in": str(dtype)[6:],
                                "block": block},
                   lambda: ops.quantize(x, block),
                   lambda: ref.quantize_ref(x, block),
                   n * (x.element_size() + 1) + 4 * n / block,
                   Q8_FLOPS["quantize"] * n)
        add("quantize", row, on_path)
        del x
    # dequantize_into: the bf16 gathers and the fp32 reduce route
    for shape, dtype, block, on_path in (
            ((layer_shard,), torch.bfloat16, 1024, True),
            ((globals_shard,), torch.bfloat16, 1024, True),
            ((layer_shard,), torch.float32, 1024, False),
            ((globals_shard,), torch.float32, 1024, False),
            (reduced_layer, torch.float32, 64, False)):
        codes, scales = ops.quantize(rnd(shape, 0.05), block)
        n = codes.numel()
        out_bytes = torch.empty((), dtype=dtype).element_size()
        row = hold("dequantize_into", {"shape": list(shape),
                                       "out": str(dtype)[6:], "block": block},
                   lambda: ops.dequantize_into(codes, scales, block,
                                               out_dtype=dtype),
                   lambda: ref.dequantize_into_ref(codes, scales, block,
                                                   dtype),
                   n * (1 + out_bytes) + 4 * n / block,
                   Q8_FLOPS["dequantize_into"] * n)
        add("dequantize_into", row, on_path)
        del codes, scales
    # encode_ef: the reduce wire's encode of a bf16 (or fp32) cotangent
    for shape, dtype, block, on_path in (
            ((layer_shard,), torch.bfloat16, 1024, True),
            ((globals_shard,), torch.bfloat16, 1024, True),
            ((layer_shard,), torch.float32, 1024, False),
            (reduced_layer, torch.float32, 64, False)):
        ct, ef = rnd(shape, 1e-3, dtype), rnd(shape, 1e-5)
        n = ct.numel()
        row = hold("encode_ef", {"shape": list(shape), "ct": str(dtype)[6:],
                                 "block": block},
                   lambda: ops.encode_ef(ct, ef, block),
                   lambda: ref.encode_ef_ref(ct, ef, block),
                   n * (ct.element_size() + 4 + 1 + 4) + 4 * n / block,
                   Q8_FLOPS["encode_ef"] * n)
        add("encode_ef", row, on_path)
        del ct, ef
    # the q8 epilogue of the AdamW update: each group's step
    for shape, block, on_path in (((L, layer_shard), 1024, True),
                                  ((globals_shard,), 1024, True),
                                  (reduced_layer, 64, False)):
        w, g, m = rnd(shape, 0.05), rnd(shape, 1e-3), rnd(shape, 1e-4)
        v = rnd(shape, 1e-4).square_()
        mask = (torch.rand(shape, generator=gen, device="cuda") < 0.8).float()
        n = w.numel()
        row = hold("adamw_q8", {"shape": list(shape), "block": block},
                   lambda: ops.adamw_store_update(w, g, m, v, mask,
                                                  fmt="q8_block", block=block,
                                                  **kw),
                   lambda: ref.adamw_store_update_ref(w, g, m, v, mask,
                                                      scalars, "q8_block",
                                                      block),
                   n * (20 + 1 + 12) + 4 * n / block,
                   Q8_FLOPS["adamw_q8"] * n)
        add("adamw_q8", row, on_path)
        del w, g, m, v, mask
    torch.cuda.empty_cache()
    return summary


def phase_kernel_adam8(ops, ref, gemma_q8_shards) -> dict:
    """The 8-bit Adam kernel against its plain version.  Returns per
    epilogue the summary the kernels line carries: the flat epilogue (fp32,
    the qwen3-moe path's) summed over qwen3-moe's layers shard and the
    compared slice of its experts shard, the q8_block epilogue over the
    gemma2-2b adam8bit q8 plan's two groups (the train_adam8_q8 path's)."""
    import math

    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    kw = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=1 - 0.9 ** 3,
              c2=1 - 0.95 ** 3)
    scalars = ref.scalar_stack(*kw.values())
    summary = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0} for k in ("flat", "q8")}

    def inputs(shape, block, offset, w_dtype, codec_moments=True):
        """Card tensors ``offset`` elements into their buffers (an odd
        offset takes the kernel's scalar path); moments from a previous
        step's codecs (or, for a timing alone, random codes and scales);
        one (S,) uint8 decay row."""
        n = math.prod(shape)

        def view(x, dtype):
            if offset == 0:
                return x.to(dtype)
            buf = torch.empty(n + offset, dtype=dtype, device="cuda")
            buf[offset:] = x.reshape(-1).to(dtype)
            return buf[offset:].view(shape)

        def rnd(scale):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        w, g = view(rnd(0.05), w_dtype), view(rnd(1e-3), torch.float32)
        if codec_moments:
            m8, ms = ops.quantize(rnd(1e-4), block)
            v8, vs = ops.quantize_log(rnd(3e-4).square_(), block)
        else:
            sshape = shape[:-1] + (shape[-1] // block,)
            m8 = torch.randint(-127, 128, shape, generator=gen,
                               device="cuda", dtype=torch.int8)
            v8 = torch.randint(0, 128, shape, generator=gen, device="cuda",
                               dtype=torch.int8)
            ms = torch.rand(sshape, generator=gen, device="cuda") * 1e-6
            vs = torch.rand(sshape, generator=gen, device="cuda") * 1e-7
        mask = (torch.rand(shape[-1], generator=gen, device="cuda") < 0.8)
        return (w, g, view(m8, torch.int8), view(v8, torch.int8), ms, vs,
                mask.to(torch.uint8))

    def cost(fmt, shape, block):
        n = math.prod(shape)
        return (n * ADAM8_BYTES[fmt] + shape[-1]
                + n // block * ADAM8_BLOCK_BYTES[fmt], n * ADAM8_FLOPS[fmt])

    L = TRAIN_LAYERS
    qwen_layers = (1, MOE_SHARDS["layers"])
    qwen_slice = (1, MOE_SLICE)
    cases = [(fmt, shape, block, offset, key)
             for fmt in ("fp32", "bf16", "q8_block")
             for shape, block, offset, key in (
                 (qwen_layers, 1024, 0, "flat" if fmt == "fp32" else None),
                 (qwen_slice, 1024, 0, "flat" if fmt == "fp32" else None),
                 ((2, 1_572_864), 64, 0, None),   # the reduced config
                 ((1, 1024 * 4096), 1024, 1, None))]  # misaligned view
    cases += [("q8_block", (L, gemma_q8_shards["layers"]), 1024, 0, "q8"),
              ("q8_block", (gemma_q8_shards["globals"],), 1024, 0, "q8")]
    for fmt, shape, block, offset, key in cases:
        t = inputs(shape, block, offset,
                   torch.bfloat16 if fmt == "bf16" else torch.float32)
        nbytes, flops = cost(fmt, shape, block)
        row = hold("adam8bit_store_update",
                   {"shape": list(shape), "fmt": fmt, "block": block,
                    "offset": offset},
                   lambda: ops.adam8bit_store_update(*t, fmt=fmt, block=block,
                                                     **kw),
                   lambda: ref.adam8bit_store_update_ref(*t, scalars, fmt,
                                                         block),
                   nbytes, flops, phase="kernel_adam8")
        if key is not None:
            st = summary[key]
            st["max_abs_err"] = max(st["max_abs_err"], row["max_abs_err"])
            for k in ("ms", "plain_ms", "bound_ms"):
                st[k] += row[k]
        del t
        torch.cuda.empty_cache()
    # the kernel alone at the full shards of the qwen3-moe step (in place,
    # as the optimizer runs it): no room for the plain version's temporaries
    for name in ("layers_experts", "globals"):
        shape = (1, MOE_SHARDS[name]) if name != "globals" \
            else (MOE_SHARDS[name],)
        t = inputs(shape, 1024, 0, torch.float32, codec_moments=False)
        out = (t[0], t[2], t[3], t[4], t[5])
        ms = median_ms(lambda: ops.adam8bit_store_update(*t, block=1024,
                                                         out=out, **kw),
                       iters=5, warmup=1)
        nbytes, flops = cost("fp32", shape, 1024)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        emit({"phase": "kernel_adam8", "name": "adam8bit_store_update",
              "shape": list(shape), "fmt": "fp32", "block": 1024,
              "alone": True, "ms": ms, "bound_ms": bound_ms, "bytes": nbytes,
              "achieved_GBps": nbytes / ms / 1e6})
        del t, out
        torch.cuda.empty_cache()
    return summary


def launches_now(mods) -> dict:
    fu = mods["fused_update"]
    return {"adamw_store_update": fu.adamw_store_update.launches,
            "adamw_q8": fu.adamw_q8_update.launches,
            "adam8bit_store_update": fu.adam8bit_store_update.launches,
            "adam8bit_q8": fu.adam8bit_q8_update.launches,
            "quantize": mods["blockwise_quant"].quantize.launches,
            "dequantize_into": mods["blockwise_quant"].dequantize_into
            .launches,
            "encode_ef": mods["encode_ef"].encode_ef.launches}


def reset_launches(mods) -> None:
    mods["fused_update"].adamw_store_update.launches = 0
    mods["fused_update"].adamw_q8_update.launches = 0
    mods["fused_update"].adam8bit_store_update.launches = 0
    mods["fused_update"].adam8bit_q8_update.launches = 0
    mods["blockwise_quant"].quantize.launches = 0
    mods["blockwise_quant"].dequantize_into.launches = 0
    mods["encode_ef"].encode_ef.launches = 0


def expected_q8_launches(rt, steps: int) -> dict:
    """What the q8 path must launch: quantize once per group at init; per
    step a dequantize_into per gather (a layer twice: forward and the
    backward's re-gather; globals once) plus one per reduce-scatter (the
    one-rank q8 route decodes the encoded cotangent), an encode_ef per
    reduce-scatter (a layer once, globals once) and one update per group."""
    gathers = sum(2 * lo.n_layers if lo.n_layers else 1
                  for lo in rt.layouts.values())
    reduces = sum(lo.n_layers or 1 for lo in rt.layouts.values())
    groups = len(rt.layouts)
    return {"adamw_store_update": 0, "adamw_q8": groups * steps,
            "adam8bit_store_update": 0, "adam8bit_q8": 0,
            "quantize": groups, "dequantize_into": (gathers + reduces) * steps,
            "encode_ef": reduces * steps}


def main() -> None:
    import torch

    # ---- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import build_model, get_config
    from repro_torch.core.fsdp import FSDPRuntime
    from repro_torch.core.policy import plan
    from repro_torch.core.schedule import CommSchedule
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import (blockwise_quant, build, encode_ef,
                                     fused_update, ops, ref)
    from repro_torch.launch.mesh import init_local_group
    from repro_torch.optim import make_optimizer

    mods = {"fused_update": fused_update, "blockwise_quant": blockwise_quant,
            "encode_ef": encode_ef}

    def train(cfg, device, compute_dtype, stream, steps, schedule=None,
              timings=None, seed=0):
        """The quickstart loop through the public API; returns (metrics
        per step, step ms, runtime) and, into ``timings``, the set-up
        seconds (runtime, init, optimizer state).  Batches are made and
        placed outside the timed region."""
        t_setup = time.perf_counter()
        rt = FSDPRuntime(build_model(cfg), group,
                         compute_dtype=compute_dtype, device=device,
                         schedule=schedule)
        params = rt.init_params(seed)
        opt = make_optimizer(cfg)
        opt_state = opt.init(rt)
        if timings is not None:
            timings["setup_s"] = time.perf_counter() - t_setup
        step_fn = rt.make_train_step(opt)
        out, times, step = [], [], 0
        for i in range(steps):
            batch = stream.shard(stream.batch(i), rt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, step, m = step_fn(params, opt_state, step,
                                                 batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            out.append({k: float(v) for k, v in m.items()})
        return out, times, rt

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build([fused_update.KERNEL, fused_update.ADAM8_KERNEL,
                         blockwise_quant.KERNEL, encode_ef.KERNEL])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"],
                          "ptxas": [l for l in v["log"].splitlines()
                                    if "registers" in l or "spill" in l]}
                      for k, v in built.items()}})

    # ---- 3. kernel vs plain --------------------------------------------
    kstats = phase_kernel(fused_update, ref)

    # ---- 4. q8 kernels vs plain at the q8 plan's shard shapes ----------
    full = get_config("gemma2-2b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    q8_plan = plan(build_model(cfg), {"data": 1, "model": 1},
                   CommSchedule(**Q8_SCHEDULE))
    q8_shards = {n: e.plan.shard_size for n, e in q8_plan.groups.items()}
    q8stats = phase_kernel_q8(ops, ref, q8_shards["layers"],
                              q8_shards["globals"])

    # ---- 5. the 8-bit Adam kernel vs plain -----------------------------
    adam8_cfg = dataclasses.replace(cfg, optimizer="adam8bit")
    adam8_q8_shards = {
        n: e.plan.shard_size for n, e in plan(
            build_model(adam8_cfg), {"data": 1, "model": 1},
            CommSchedule(**ADAM8_Q8_SCHEDULE)).groups.items()}
    a8stats = phase_kernel_adam8(ops, ref, adam8_q8_shards)

    # ---- 6. fp32 path: gemma2-2b at full width, depth cut to 4 ---------
    group = init_local_group("cpu:gloo,cuda:nccl")
    stream = SyntheticStream(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH),
                             cfg)
    t0 = time.perf_counter()
    emit({"phase": "train_setup", "model": cfg.name,
          "cut": {"n_layers": [full.n_layers, TRAIN_LAYERS]},
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "batch": [TRAIN_BATCH, TRAIN_SEQ]})
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    metrics, times, rt = train(cfg, "cuda", torch.bfloat16, stream,
                               1 + TIMED_STEPS)
    launches = fused_update.adamw_store_update.launches
    peak = torch.cuda.max_memory_allocated()
    shards = {n: lo.plan.shard_size for n, lo in rt.layouts.items()}
    n_params = sum(math.prod(lo.local_shape()) for lo in rt.layouts.values())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, (m, ms) in enumerate(zip(metrics, times)):
        emit({"phase": "train", "step": i, "warmup": i == 0,
              "loss": m["loss"], "grad_norm": m["grad_norm"],
              "tokens": m["tokens"], "step_ms": ms,
              "tokens_per_s": tokens / (ms / 1e3)})
    timed = times[1:]
    summary = {"phase": "train_summary", "shard_sizes": shards,
               "params": n_params,
               "setup_and_steps_s": time.perf_counter() - t0,
               "step_ms_median": statistics.median(timed),
               "tokens_per_s": tokens / (statistics.median(timed) / 1e3),
               "max_memory_allocated": peak, "kernel_launches": launches,
               "expected_launches": len(rt.layouts) * len(metrics)}
    emit(summary)
    if shards != {"layers": 77_865_984, "globals": 589_826_304}:
        fail(f"unexpected shard sizes {shards}")
    if launches != len(rt.layouts) * len(metrics):
        fail(f"adamw_store_update launched {launches} times on the main "
             f"path, expected {len(rt.layouts) * len(metrics)}")
    for m in metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"non-finite train metrics {m}")
    # random init: the first loss is close to uniform over the vocab
    if abs(metrics[0]["loss"] - math.log(cfg.vocab)) > 1.0:
        fail(f"first loss {metrics[0]['loss']} far from ln(vocab) "
             f"{math.log(cfg.vocab)}")
    del rt
    torch.cuda.empty_cache()

    # ---- 7. q8 path: the same model and batch, q8_both_wires -----------
    q8_sched = CommSchedule(**Q8_SCHEDULE)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    t0 = time.perf_counter()
    q8_metrics, q8_times, rt = train(cfg, "cuda", torch.bfloat16, stream,
                                     1 + TIMED_STEPS, q8_sched)
    q8_launches = launches_now(mods)
    q8_peak = torch.cuda.max_memory_allocated()
    q8_want = expected_q8_launches(rt, len(q8_metrics))
    shards = {n: lo.plan.shard_size for n, lo in rt.layouts.items()}
    for i, (m, ms) in enumerate(zip(q8_metrics, q8_times)):
        emit({"phase": "train_q8", "step": i, "warmup": i == 0,
              "loss": m["loss"], "grad_norm": m["grad_norm"],
              "tokens": m["tokens"], "step_ms": ms,
              "tokens_per_s": tokens / (ms / 1e3)})
    timed = q8_times[1:]
    emit({"phase": "train_q8_summary", "schedule": Q8_SCHEDULE,
          "shard_sizes": shards, "planned_shard_sizes": q8_shards,
          "setup_and_steps_s": time.perf_counter() - t0,
          "step_ms_median": statistics.median(timed),
          "tokens_per_s": tokens / (statistics.median(timed) / 1e3),
          "max_memory_allocated": q8_peak, "kernel_launches": q8_launches,
          "expected_launches": q8_want})
    if shards != q8_shards:
        fail(f"q8 shard sizes {shards} differ from the plan's {q8_shards}")
    if q8_launches != q8_want:
        fail(f"q8 path launched {q8_launches}, expected {q8_want}")
    for m in q8_metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"non-finite q8 train metrics {m}")
    if abs(q8_metrics[0]["loss"] - math.log(cfg.vocab)) > 1.0:
        fail(f"first q8 loss {q8_metrics[0]['loss']} far from ln(vocab) "
             f"{math.log(cfg.vocab)}")
    del rt
    torch.cuda.empty_cache()

    # ---- 8. 8-bit Adam path: qwen3-moe at full width, depth cut to 1 ---
    moe_full = get_config(MOE)
    moe_cfg = dataclasses.replace(
        moe_full, n_layers=MOE_LAYERS,
        parallel=dataclasses.replace(moe_full.parallel, ep=1))
    moe_stream = SyntheticStream(DataConfig(moe_cfg.vocab, MOE_SEQ,
                                            MOE_BATCH), moe_cfg)
    emit({"phase": "train_moe_setup", "model": moe_cfg.name,
          "cut": {"n_layers": [moe_full.n_layers, MOE_LAYERS],
                  "ep": [moe_full.parallel.ep, 1],
                  "batch": [[256, 4096], [MOE_BATCH, MOE_SEQ]]},
          "d_model": moe_cfg.d_model,
          "heads": [moe_cfg.n_heads, moe_cfg.n_kv_heads],
          "head_dim": moe_cfg.hd, "experts": [moe_cfg.n_experts,
                                              moe_cfg.top_k],
          "d_ff": moe_cfg.d_ff, "vocab": moe_cfg.vocab,
          "optimizer": moe_cfg.optimizer})
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    t0 = time.perf_counter()
    moe_timing = {}
    moe_metrics, moe_times, rt = train(moe_cfg, "cuda", torch.bfloat16,
                                       moe_stream, 1 + TIMED_STEPS,
                                       timings=moe_timing)
    moe_launches = launches_now(mods)
    moe_peak = torch.cuda.max_memory_allocated()
    moe_want = {k: 0 for k in moe_launches}
    moe_want["adam8bit_store_update"] = len(rt.layouts) * len(moe_metrics)
    shards = {n: lo.plan.shard_size for n, lo in rt.layouts.items()}
    moe_tokens = MOE_BATCH * MOE_SEQ
    for i, (m, ms) in enumerate(zip(moe_metrics, moe_times)):
        emit({"phase": "train_moe", "step": i, "warmup": i == 0,
              "loss": m["loss"], "grad_norm": m["grad_norm"],
              "tokens": m["tokens"], "step_ms": ms,
              "tokens_per_s": moe_tokens / (ms / 1e3)})
    timed = moe_times[1:]
    # random init: logits ~ N(0, 4) (the final norm's gain 1 + 1 on unit-RMS
    # activations, an untied head of fan-in d_model), so the first loss is
    # near ln(vocab) + 4/2
    moe_loss0 = math.log(moe_cfg.vocab) + 2.0
    emit({"phase": "train_moe_summary", "shard_sizes": shards,
          "params": sum(math.prod(lo.local_shape())
                        for lo in rt.layouts.values()),
          "setup_s": moe_timing["setup_s"],
          "setup_and_steps_s": time.perf_counter() - t0,
          "step_ms_median": statistics.median(timed),
          "tokens_per_s": moe_tokens / (statistics.median(timed) / 1e3),
          "max_memory_allocated": moe_peak, "kernel_launches": moe_launches,
          "expected_launches": moe_want, "expected_first_loss": moe_loss0})
    if shards != MOE_SHARDS:
        fail(f"qwen3-moe shard sizes {shards}, expected {MOE_SHARDS}")
    if moe_launches != moe_want:
        fail(f"qwen3-moe path launched {moe_launches}, expected {moe_want}")
    for m in moe_metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"non-finite qwen3-moe train metrics {m}")
    if abs(moe_metrics[0]["loss"] - moe_loss0) > 1.0:
        fail(f"first qwen3-moe loss {moe_metrics[0]['loss']} far from "
             f"{moe_loss0}")
    del rt
    torch.cuda.empty_cache()

    # ---- 9. 8-bit Adam on the q8_block store: gemma2-2b as in 6 --------
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    t0 = time.perf_counter()
    a8q_metrics, a8q_times, rt = train(
        adam8_cfg, "cuda", torch.bfloat16, stream, 1 + TIMED_STEPS,
        CommSchedule(**ADAM8_Q8_SCHEDULE))
    a8q_launches = launches_now(mods)
    a8q_peak = torch.cuda.max_memory_allocated()
    gathers = sum(2 * lo.n_layers if lo.n_layers else 1
                  for lo in rt.layouts.values())
    a8q_want = {k: 0 for k in a8q_launches}
    a8q_want.update(adam8bit_q8=len(rt.layouts) * len(a8q_metrics),
                    quantize=len(rt.layouts),
                    dequantize_into=gathers * len(a8q_metrics))
    shards = {n: lo.plan.shard_size for n, lo in rt.layouts.items()}
    for i, (m, ms) in enumerate(zip(a8q_metrics, a8q_times)):
        emit({"phase": "train_adam8_q8", "step": i, "warmup": i == 0,
              "loss": m["loss"], "grad_norm": m["grad_norm"],
              "tokens": m["tokens"], "step_ms": ms,
              "tokens_per_s": tokens / (ms / 1e3)})
    timed = a8q_times[1:]
    emit({"phase": "train_adam8_q8_summary", "schedule": ADAM8_Q8_SCHEDULE,
          "optimizer": "adam8bit", "shard_sizes": shards,
          "planned_shard_sizes": adam8_q8_shards,
          "setup_and_steps_s": time.perf_counter() - t0,
          "step_ms_median": statistics.median(timed),
          "tokens_per_s": tokens / (statistics.median(timed) / 1e3),
          "max_memory_allocated": a8q_peak, "kernel_launches": a8q_launches,
          "expected_launches": a8q_want})
    if shards != adam8_q8_shards:
        fail(f"adam8bit q8 shard sizes {shards} differ from the plan's "
             f"{adam8_q8_shards}")
    if a8q_launches != a8q_want:
        fail(f"adam8bit q8 path launched {a8q_launches}, expected "
             f"{a8q_want}")
    for m in a8q_metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"non-finite adam8bit q8 train metrics {m}")
    if abs(a8q_metrics[0]["loss"] - math.log(cfg.vocab)) > 1.0:
        fail(f"first adam8bit q8 loss {a8q_metrics[0]['loss']} far from "
             f"ln(vocab) {math.log(cfg.vocab)}")
    del rt
    torch.cuda.empty_cache()

    # ---- 10. CPU (plain versions) vs card (kernels) --------------------
    small = get_config("gemma2-2b").reduced()
    moe_small = get_config(MOE).reduced()
    for phase, model, sched, rtol in (
            ("parity", small, None, PARITY_RTOL),
            ("parity_q8", small, Q8_SCHEDULE, PARITY_Q8_RTOL),
            ("parity_moe", moe_small, None, PARITY_RTOL),
            ("parity_moe", moe_small, ADAM8_Q8_SCHEDULE, PARITY_Q8_RTOL)):
        readings = []
        for seed in PARITY_SEEDS:
            data = SyntheticStream(DataConfig(model.vocab, 64, 8, seed=seed),
                                   model)
            runs = {dev: train(model, dev, torch.float32, data, 2,
                               sched and CommSchedule(**sched),
                               seed=seed)[0]
                    for dev in ("cpu", "cuda")}
            readings.append(max(abs(a[k] - b[k]) / abs(b[k])
                                for a, b in zip(runs["cuda"], runs["cpu"])
                                for k in ("loss", "grad_norm")))
        emit({"phase": phase, "config": f"{model.name}.reduced()",
              "optimizer": model.optimizer,
              "schedule": sched or "default", "compute": "float32",
              "seeds": list(PARITY_SEEDS), "max_rel_diff": readings,
              "rtol": rtol})
        if not max(readings) <= rtol:
            fail(f"{phase}: CPU and card runs differ by {max(readings)} > "
                 f"{rtol}")

    # ---- 11. kernels line, card, last line -----------------------------
    csrc = "src/repro_torch/kernels/csrc/"

    def entry(name, source, replaces, launches, st):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": st["max_abs_err"], "ms": st["ms"],
                "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                "bound_by": "bytes", "library_ms": None}

    emit({"kernels": [
        entry("adamw_store_update", "adamw_store_update.cu",
              "src/repro/kernels/fused_update.py:85", launches, kstats),
        entry("adamw_store_update_q8", "adamw_store_update.cu",
              "src/repro/kernels/fused_update.py:102",
              q8_launches["adamw_q8"], q8stats["adamw_q8"]),
        entry("quantize", "blockwise_quant.cu",
              "src/repro/kernels/blockwise_quant.py:56",
              q8_launches["quantize"], q8stats["quantize"]),
        entry("dequantize_into", "blockwise_quant.cu",
              "src/repro/kernels/blockwise_quant.py:66",
              q8_launches["dequantize_into"], q8stats["dequantize_into"]),
        entry("encode_ef", "encode_ef.cu",
              "src/repro/kernels/encode_ef.py:30",
              q8_launches["encode_ef"], q8stats["encode_ef"]),
        entry("adam8bit_store_update", "adam8bit_store_update.cu",
              "src/repro/kernels/fused_update.py:116",
              moe_launches["adam8bit_store_update"], a8stats["flat"]),
        entry("adam8bit_store_update_q8", "adam8bit_store_update.cu",
              "src/repro/kernels/fused_update.py:145",
              a8q_launches["adam8bit_q8"], a8stats["q8"]),
    ]})
    torch.distributed.destroy_process_group()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
