"""The dry run (``repro_torch.launch.dryrun``, ``launch.specs``, the
production mesh) against closed forms and the reference's plan.

The dry runs execute in three subprocesses at once
(``tests/_torch_dryrun_worker.py``, a third of them each): each makes its
own fake default process group, which a test process that holds a gloo
group already cannot.  The reference's ``plan_only`` runs
in this process (host only; importing ``repro.launch.dryrun`` sets
``XLA_FLAGS`` for 512 host devices, which is put back at once, before
anything here initialises a JAX backend).

Parity classes:
  * ``plan_only`` text: string-equal to the reference's, every ported arch
    on both production meshes;
  * the full-width gemma2-2b and hymba-1.5b ``train_4k`` rows at 16 x 16:
    ``model_gflops``, ``gather_wire_mb`` and ``reduce_wire_mb`` equal the
    reference's;
  * xlstm-125m at published width on 16 x 16 (a train step of 130 tokens
    a row, a decode): FLOPs, collectives and argument bytes equal their
    closed forms.  Its ``train_4k`` row takes minutes on meta tensors (the
    sLSTM's op-by-op loop over 4,096 positions) and runs on the card's
    host instead (``chip_smoke.py`` ``dryrun_production``);
  * the reduced 4 x 2 meta step: FLOPs, collective counts and volumes and
    argument bytes equal their closed forms (stated in each test).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.cache import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's three parts, run at once; their rows (``written``)
    in part order."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    worker = os.path.join(ROOT, "tests", "_torch_dryrun_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(out), str(part)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for part in range(3)]
    res = {"written": []}
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-4000:]
        line = next(l for l in stdout.splitlines() if l.startswith("RESULT "))
        part = json.loads(line[len("RESULT "):])
        res["written"] += part.pop("written")
        res.update(part)
    return res


def _reference_dryrun():
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


@pytest.mark.parametrize("multi_pod", [False, True])
def test_plan_only_is_the_reference_text(multi_pod):
    from repro_torch.launch import dryrun

    ref = _reference_dryrun()
    for arch in ARCH_IDS:
        assert dryrun.plan_only(arch, multi_pod=multi_pod) == \
            ref.plan_only(arch, multi_pod=multi_pod), arch


def test_production_axis_sizes():
    from repro.launch.mesh import production_axis_sizes as ref
    from repro_torch.launch.mesh import production_axis_sizes

    for mp in (False, True):
        assert production_axis_sizes(multi_pod=mp) == ref(multi_pod=mp)


def _reduced():
    full = get_config("gemma2-2b")
    return dataclasses.replace(full.reduced(), parallel=full.parallel)


def test_meta_step_flops_closed_form(runs):
    """Per layer forward, on the N = b T tokens of rank 0 (b = B / 8 rows):
    q and o 2 N D (Hq hd) each, k and v 2 N D (Hkv hd) each, the two
    attention products 2 b Hq T^2 hd each (dense over every key: the mask
    is applied, not skipped), the GeGLU 3 x 2 N D F; each layer runs
    forward, its recompute in backward and a backward of twice the
    forward.  The tied head 2 N D V forward and twice that backward; the
    embedding gather counts none."""
    cfg = _reduced()
    L, D, V, F = cfg.n_layers, cfg.d_model, cfg.vocab, cfg.d_ff
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, T = 8, 32
    b = B // 8
    N = b * T
    layer = (2 * 2 * N * D * Hq * hd + 2 * 2 * N * D * Hkv * hd
             + 2 * 2 * b * Hq * T * T * hd + 3 * 2 * N * D * F)
    assert runs["reduced_train"]["flops"] == L * layer * 4 + 3 * 2 * N * D * V
    # serve: one forward, no recompute, no backward; decode reads T keys
    pre = runs["reduced_prefill"]["flops"]
    assert pre == L * layer + 2 * (B // 8) * D * V  # logits of the last row
    dec = runs["reduced_decode"]["flops"]
    n = B // 8
    dec_layer = (2 * 2 * n * D * Hq * hd + 2 * 2 * n * D * Hkv * hd
                 + 2 * 2 * n * Hq * T * hd + 3 * 2 * n * D * F)
    assert dec == L * dec_layer + 2 * n * D * V


def test_meta_step_collectives_closed_form(runs):
    """All-gathers: ``globals`` once and each layer twice (forward and its
    recompute), each of the group's gathered buffer, so their buffers sum
    to gather_wire(globals) + 2 gather_wire(layers); reduce-scatters once a
    gather's backward, summing to the plan's reduce_wire_bytes; every
    collective over the m = 8 ranks of the group's FSDP axes; volume =
    buffer (m - 1) / m; two all-reduces (the loss sums, the norm)."""
    r = runs["reduced_train"]
    g = r["groups"]
    L = g["layers"]["n_layers"]
    kinds = {}
    for kind, m, buf in r["collectives"]:
        kinds.setdefault(kind, []).append((m, buf))
    assert len(kinds["all-gather"]) == 1 + 2 * L
    assert len(kinds["reduce-scatter"]) == 1 + L
    assert len(kinds["all-reduce"]) == 2
    assert {m for m, _ in kinds["all-gather"] + kinds["reduce-scatter"]} \
        == {8} == {g[n]["m"] for n in g}
    assert sum(b for _, b in kinds["all-gather"]) == \
        g["globals"]["gather"] + 2 * g["layers"]["gather"]
    assert sum(b for _, b in kinds["reduce-scatter"]) == \
        g["globals"]["reduce"] + g["layers"]["reduce"]
    from repro_torch.launch.roofline import collective_stats

    st = collective_stats(r["collectives"])
    assert st.bytes_by_kind["all-gather"] == pytest.approx(
        (g["globals"]["gather"] + 2 * g["layers"]["gather"]) * 7 / 8)
    assert st.bytes_by_kind["reduce-scatter"] == pytest.approx(
        (g["globals"]["reduce"] + g["layers"]["reduce"]) * 7 / 8)
    # serve: the same gathers without the recompute, no reduce-scatter
    for kind in ("prefill", "decode"):
        got = [c[0] for c in runs[f"reduced_{kind}"]["collectives"]]
        assert got.count("all-gather") >= 1 + L
        assert "reduce-scatter" not in got


def test_ring_route_hops(runs):
    """The ring gather mode: every gather and reduce-scatter of the step
    is m - 1 = 7 hops over ``batch_isend_irecv`` (one ``send`` each, a
    ``collective-permute`` of one shard), and no all-gather or
    reduce-scatter is left."""
    r = runs["reduced_ring"]
    g = r["groups"]
    L = g["layers"]["n_layers"]
    kinds = [c[0] for c in r["collectives"]]
    assert kinds.count("collective-permute") == 7 * ((1 + 2 * L) + (1 + L))
    assert "all-gather" not in kinds and "reduce-scatter" not in kinds


def test_meta_step_argument_bytes(runs):
    """Exactly the fp32 masters (L S_layers + S_globals elements), AdamW's
    fp32 m and v, its fp32 decay masks of the same shapes
    (``held_tensors``) and the int64 token rows of rank 0."""
    r = runs["reduced_train"]
    g = r["groups"]
    elems = g["layers"]["n_layers"] * g["layers"]["shard"] \
        + g["globals"]["shard"]
    assert r["arg_bytes"] == 4 * elems * 4 + 1 * 32 * 8
    assert r["kernels"] == {"adamw_store_update[fp32]": 2}
    assert r["temp_peak"] > 0


def test_pod_mesh_and_expert_exchange(runs):
    """qwen3-moe.reduced() at ep 2 on pod 2 x data 2 x model 2: the EP
    all-to-alls over the model axis (2 ranks), one 8-bit Adam call a
    group, the cross-pod gradient all-reduce."""
    r = runs["moe_pod"]
    kinds = [c[0] for c in r["collectives"]]
    assert kinds.count("all-to-all") > 0
    assert all(m == 2 for k, m, _ in r["collectives"] if k == "all-to-all")
    assert set(r["kernels"]) == {"adam8bit_store_update[fp32]"}
    assert sum(r["kernels"].values()) == len(r["groups"])


def test_full_width_row_is_the_reference_plan(runs):
    from repro.configs import build_model, get_config as ref_config
    from repro.configs.base import SHAPES
    from repro.core.policy import make_plan
    from repro.launch.mesh import production_axis_sizes
    from repro.launch.roofline import model_flops

    row = runs["full"]
    cfg = ref_config("gemma2-2b")
    plan = make_plan(build_model(cfg), production_axis_sizes(), None)
    assert row["ok"] and row["mesh"] == "pod16x16"
    assert row["model_gflops"] == round(
        model_flops(cfg, SHAPES["train_4k"]) / 1e9, 1)
    assert row["gather_wire_mb"] == round(plan.gather_wire_bytes() / 1e6, 3)
    assert row["reduce_wire_mb"] == round(plan.reduce_wire_bytes() / 1e6, 3)
    assert row["colls"] == {"all-gather": 53, "reduce-scatter": 27,
                            "all-reduce": 2}
    assert row["kernel_calls"] == {"adamw_store_update[fp32]": 2}
    assert math.isclose(row["peak_bytes_dev"],
                        row["arg_bytes_dev"] + row["temp_gb_dev"] * 1e9,
                        rel_tol=1e-3)


def test_error_and_skip_rows(runs):
    """seamless-m4t-medium (once an unported family's error row) is an
    ``ok`` row at published width and depth: its model FLOPs and wire
    bytes the reference's, each of its 12 + 12 layers gathered twice and
    reduce-scattered once; a pure full-attention arch at long_500k the
    reference's skip; the full-width gemma2-2b row, run with --verify, proved
    its plan's nine invariants with no violation from its own step; every
    row is appended to --out."""
    from repro.configs import build_model, get_config as ref_config
    from repro.configs.base import SHAPES
    from repro.core.policy import make_plan
    from repro.launch.mesh import production_axis_sizes
    from repro.launch.roofline import model_flops

    row = runs["seamless"]
    cfg = ref_config("seamless-m4t-medium")
    plan = make_plan(build_model(cfg), production_axis_sizes(), None)
    assert row["ok"] is True
    assert row["model_gflops"] == round(
        model_flops(cfg, SHAPES["train_4k"]) / 1e9, 1)
    assert row["gather_wire_mb"] == round(plan.gather_wire_bytes() / 1e6, 3)
    assert row["colls"] == {"all-gather": 49, "reduce-scatter": 25,
                            "all-reduce": 2}
    assert row["kernel_calls"] == {"adamw_store_update[fp32]": 3}
    skip = runs["skip"]
    assert skip["ok"] is False and skip["mesh"] == "pod2x16x16"
    assert skip["note"] == ("SKIP: pure full-attention arch: 500k dense KV "
                            "out of scope")
    assert runs["full"]["verify"]["checked"] == 9
    assert runs["full"]["verify"]["errors"] == 0
    assert runs["full"]["verify"]["warnings"] == 0
    assert [r["arch"] for r in runs["written"]] == [
        "gemma2-2b", "hymba-1.5b", "hymba-1.5b", "seamless-m4t-medium",
        "qwen2.5-14b"]


def _prod_plan(arch):
    from repro_torch.configs import build_model
    from repro_torch.core.policy import plan
    from repro_torch.launch.mesh import production_axis_sizes

    return plan(build_model(get_config(arch)), production_axis_sizes())


def _param_bytes(plan) -> int:
    """fp32 master bytes a rank holds: every group's shard, a stacked
    group's once a layer."""
    return 4 * sum(e.plan.shard_size * (e.n_layers or 1)
                   for e in plan.groups.values())


def test_hymba_rows_are_the_reference_plan(runs):
    """hymba-1.5b at published width and depth on 16 x 16: the ``train_4k``
    row's model FLOPs and wire bytes are the reference's, each of the 32
    layers gathers twice (forward, recompute) and reduce-scatters once,
    AdamW runs once a group; the ``long_500k`` decode (one row, a cache
    capped at the 1,024 window past 65,536 positions) gathers each layer
    once and holds the fp32 shards, its one row of the cache and the
    token as arguments."""
    import torch

    from repro.configs import build_model, get_config as ref_config
    from repro.configs.base import SHAPES
    from repro.core.policy import make_plan
    from repro.launch.mesh import production_axis_sizes
    from repro.launch.roofline import model_flops
    from repro_torch.configs import build_model as port_build

    row = runs["hymba"]
    cfg = ref_config("hymba-1.5b")
    plan = make_plan(build_model(cfg), production_axis_sizes(), None)
    assert row["ok"] and row["mesh"] == "pod16x16"
    assert row["model_gflops"] == round(
        model_flops(cfg, SHAPES["train_4k"]) / 1e9, 1)
    assert row["gather_wire_mb"] == round(plan.gather_wire_bytes() / 1e6, 3)
    assert row["reduce_wire_mb"] == round(plan.reduce_wire_bytes() / 1e6, 3)
    assert row["colls"] == {"all-gather": 1 + 2 * 32,
                            "reduce-scatter": 1 + 32, "all-reduce": 2}
    assert row["kernel_calls"] == {"adamw_store_update[fp32]": 2}
    assert row["temp_gb_dev"] > 0
    long = runs["hymba_long"]
    assert long["ok"] and long["colls"] == {"all-gather": 1 + 32}
    model = port_build(get_config("hymba-1.5b"))
    assert model.cache_window(524_288) == 1024
    cache = sum(torch.empty(sd[0], dtype=sd[1], device="meta").nbytes
                for _, sd in leaves(model.cache_shapes(1, 524_288)))
    assert long["arg_bytes_dev"] == \
        _param_bytes(_prod_plan("hymba-1.5b")) + cache + 8


def test_xlstm_meta_steps_closed_form(runs):
    """xlstm-125m at published width and depth (2 blocks of 5 mLSTM cells
    and an sLSTM cell) on 16 x 16, rank 0's one row of N = 130 tokens.
    Matmul FLOPs of a cell's forward (H = 4 heads of hd = 192; two chunks
    of c = 128, the second padded from 2 positions): the mLSTM's five D x
    D projections and its gate projection (2 N D 2H), and per chunk q k^T
    and scores v (2 H c^2 hd each), q C and k^T v (2 H c hd^2 each) and q
    n (2 H c hd), padding included; the sLSTM's 2 N D 4D and 2 N D^2.  A block runs forward, its
    recompute and a backward of twice its forward, less the products one
    of whose operands needs no gradient: the first chunk's q C and q n
    read the zero initial state (no state half), and the last chunk's k^T
    v makes the final state, which nothing reads in training (neither
    half); and the recompute stops once it has rebuilt every tensor
    backward saved (non-reentrant checkpointing), before the block's last
    product, the sLSTM's output projection, whose result nothing saves.
    The untied head: 2 N D V forward, twice that backward.  The
    collectives: two all-gathers a block and one of ``globals``, a
    reduce-scatter each, two all-reduces; AdamW once a group.  The decode
    of one token on 128 rows (8 a rank: the batch splits over the data
    axis alone) holds the fp32 shards, its 8 rows of the nested cache
    and the tokens as arguments."""
    import torch

    from repro_torch.configs import build_model

    cfg = get_config("xlstm-125m")
    D, V, H = cfg.d_model, cfg.vocab, cfg.n_heads
    hd, T, c, blocks = D // H, 130, 128, 2
    N, padded = T, 2 * c
    mlstm = (5 * 2 * N * D * D + 2 * N * D * 2 * H
             + H * padded * (4 * hd * hd + 2 * hd + 4 * c * hd))
    mlstm_no_grad = 2 * H * c * hd * hd + 2 * H * c * hd + 4 * H * c * hd * hd
    slstm = 2 * N * D * 4 * D + 2 * N * D * D
    block = 5 * (4 * mlstm - mlstm_no_grad) + 4 * slstm - 2 * N * D * D
    r = runs["xlstm_train"]
    assert r["flops"] == blocks * block + 3 * 2 * N * D * V
    kinds = [k for k, _, _ in r["collectives"]]
    assert kinds.count("all-gather") == 1 + 2 * blocks
    assert kinds.count("reduce-scatter") == 1 + blocks
    assert kinds.count("all-reduce") == 2
    assert r["kernels"] == {"adamw_store_update[fp32]": 2}
    params = _param_bytes(_prod_plan("xlstm-125m"))
    assert r["arg_bytes"] == 4 * params + 8 * T      # master, m, v, masks
    d = runs["xlstm_decode"]
    row = sum(torch.empty(sd[0], dtype=sd[1], device="meta").nbytes
              for _, sd in leaves(build_model(cfg).cache_shapes(1, 32768)))
    assert d["arg_bytes"] == params + 8 * row + 8 * 128
    assert d["kernels"] == {}


def test_meta_device_only_when_named():
    """``device="meta"`` is taken only when the caller names it; the
    meta parameters are shapes without host work."""
    import torch

    from repro_torch.core.fsdp import _resolve_device

    assert _resolve_device("meta") == torch.device("meta")
    assert _resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _resolve_device(None)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_structure(t) for t in tree)
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "fp8_e4m3", "q8_block"])
def test_kernel_meta_branch_is_the_plain_structure(fmt):
    """Every op of ``kernels.ops`` on meta tensors returns what its plain
    version returns on CPU tensors of the same shapes (structure, shapes,
    dtypes), runs none of it, and records one ledger entry of the bytes
    its inputs and outputs hold (each once a side)."""
    import torch

    from repro_torch.kernels import ops

    n, block = 4 * 256, 256
    wdt = torch.bfloat16 if fmt == "bf16" else torch.float32
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=0.1, c2=0.05)

    def calls(dev):
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        x, w, g = z(2, n), z(2, n, dtype=wdt), z(2, n, dtype=wdt)
        codes, scales = z(2, n, dtype=torch.int8), z(2, n // block)
        m8, v8 = z(2, n, dtype=torch.int8), z(2, n, dtype=torch.int8)
        return {
            "quantize": lambda: ops.quantize(x, block),
            "dequantize_into": lambda: ops.dequantize_into(
                codes, scales, block, out_dtype=torch.bfloat16),
            "dequantize": lambda: ops.dequantize(codes, scales, block),
            "encode_ef": lambda: ops.encode_ef(x.bfloat16(), x, block),
            "q8_matmul": lambda: ops.q8_matmul(
                z(3, 256), z(256, 512, dtype=torch.int8),
                z(256 * 512 // block), block),
            "adamw_store_update": lambda: ops.adamw_store_update(
                w, g, x, x.clone(), x.clone(), fmt=fmt, block=block, **kw),
            "adam8bit_store_update": lambda: ops.adam8bit_store_update(
                w, g, m8, v8, scales, scales.clone(),
                z(n, dtype=torch.uint8), fmt=fmt, block=block, **kw),
        }

    ledger = []
    with ops.recording(ledger):
        meta = {k: f() for k, f in calls("meta").items()}
    plain = {k: f() for k, f in calls("cpu").items()}
    for k in plain:
        assert _structure(meta[k]) == _structure(plain[k]), k
    assert [e["kernel"] for e in ledger] == [
        "quantize", "dequantize_into", "dequantize", "encode_ef",
        "q8_matmul", f"adamw_store_update[{fmt}]",
        f"adam8bit_store_update[{fmt}]"]
    # quantize: fp32 x in; int8 codes and fp32 scales out
    assert ledger[0]["bytes"] == 2 * n * 4 + 2 * n + 2 * (n // block) * 4
    assert ledger[4]["flops"] == 2 * 3 * 256 * 512
