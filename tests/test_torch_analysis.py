"""Plan verification and the layering lint of the port
(``repro_torch.analysis``, ``repro_torch.tools.verify_plan``,
``repro_torch.tools.lint``) held against the reference's own checking code,
``repro.analysis.verify`` and ``repro.analysis.lint``, loaded through a stub
parent package (``tests/_torch_ref_analysis.py`` says why: on JAX 0.9.0
``repro/analysis/jaxpr.py`` cannot be imported, so ``tests/test_analysis.py``
stays red and is not touched).

  (a) ``ShardingPlan.invariants()`` equals the reference's for every arch,
      planner and policy set ``tests/test_torch_plan.py`` builds at 8 ranks,
      the q8 ring, ring-chunk, fp8 and prefetch variants among them;
  (b) ``verify_plan_static`` gives the reference's ``checked`` labels and
      violations on the same plans, tampered ring chunks among them;
  (c) the port's ``CommTrace`` and ``BufferTrace`` of gemma2-2b.reduced()
      at 8 fake ranks (default and q8) verify clean in both packages'
      ``verify_trace``, with the same labels;
  (d) ``tools.verify_plan --break`` names the group and the invariant, a
      tampered plan that verified clean would fail the command, and a
      keep-all step against a plan declaring reshard-after-forward trips
      ``gathered_peak`` in both packages;
  (e) ``bare-assert``, ``quant-blockwise`` and ``tracked-bytecode`` give
      the reference's findings on the same fixture trees;
      ``no-reference-import`` flags an import of JAX or ``repro`` in the
      port, and the port's tree is lint clean;
  (f) ``FSDPRuntime(verify=True)`` and ``launch.train.main([..., "--verify"])``
      on the CPU report clean (``tests/test_torch_dryrun.py`` runs
      ``dryrun --verify`` at the production mesh);
  (g) ``ServeEngine`` refuses seamless-m4t-medium (its cache's memory is
      written by prefill only) and still serves the VLM.

Parity classes: invariants, static reports and lint findings are EQUAL
(``==``); the trace-backed reports have the same labels and are both clean.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch
from _torch_ref_analysis import reference_analysis
from test_torch_plan import DUMPS_ARCHS, PLANNERS, _models, _policy_sets

from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core import policy as jax_policy
from repro.core.schedule import VARIANTS as JAX_VARIANTS
from repro.core.schedule import CommSchedule as JaxSchedule
from repro.core.wire import _snap_chunk

from repro_torch.analysis import lint, trace_plan, verify
from repro_torch.configs import build_model, get_config
from repro_torch.core import policy
from repro_torch.core.fsdp import FSDPRuntime
from repro_torch.core.schedule import CommSchedule
from repro_torch.launch.mesh import init_local_group
from repro_torch.tools import verify_plan as verify_tool

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH8 = {"data": 8, "model": 1}


def _jax_q8_ring():
    return dataclasses.replace(
        JAX_VARIANTS["overlap_all"], param_store="q8_block",
        reduce_wire="q8_block", reduce_dtype=None, reduce_mode="ring_acc",
        gather_mode="ring")


def _extra_sets():
    """(label, port policies, reference policies) beyond test_torch_plan's:
    the q8 ring variant, a declared ring chunk, the fp8 store and the
    prefetch / keep-last / keep-all structures."""
    pairs = [("q8_ring", verify_tool.q8_schedule(), _jax_q8_ring())]
    for label, kw in (
            ("ring_chunk", dict(param_store="q8_block", gather_mode="ring",
                                ring_chunk_elems=4096)),
            ("fp8", dict(param_store="fp8_e4m3")),
            ("prefetch_keep_last", dict(prefetch=True,
                                        keep_last_gathered=True)),
            ("keep_all", dict(reshard_after_forward=False))):
        pairs.append((label, CommSchedule(**kw), JaxSchedule(**kw)))
    return pairs


# --------------------------------------------------------------------------- #
# (a) the declared invariants
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", DUMPS_ARCHS)
def test_invariants_equal_reference(arch):
    """Every planner x policy set of ``test_torch_plan`` (published width,
    8 ranks, bf16) and the extra variants: ``plan.invariants()`` is the
    reference's, dict for dict; where the reference refuses the plan the
    combination is not compared (``test_torch_plan`` holds the port to
    the same error)."""
    jm, tm = _models(arch)
    compared = 0
    for mode in PLANNERS:
        for label, tpol, jpol in (_policy_sets(tm.cfg.parallel)
                                  + _extra_sets()):
            try:
                ref = jax_policy.plan(jm, MESH8, jpol, planner=mode)
            except ValueError:
                continue
            got = policy.plan(tm, MESH8, tpol, planner=mode)
            assert got.invariants() == ref.invariants(), (mode, label)
            compared += 1
    assert compared >= 20


# --------------------------------------------------------------------------- #
# (b) the static pass
# --------------------------------------------------------------------------- #
def _with_chunk(plan, chunk):
    """``plan`` with its largest group's ring chunk declared ``chunk``."""
    gname = max(plan.groups, key=lambda n: plan.groups[n].plan.total)
    e = plan.groups[gname]
    pol = dataclasses.replace(e.policy, ring_chunk_elems=chunk)
    return dataclasses.replace(plan, groups={
        **dict(plan.groups), gname: dataclasses.replace(e, policy=pol)})


def _report(r):
    return (r.checked, [(v.group, v.invariant, v.expected, v.found,
                         v.where, v.severity) for v in r.violations])


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-14b"])
def test_static_report_equals_reference(arch, monkeypatch):
    """``verify_plan_static`` on the default, q8-ring and auto plans of the
    reduced config at 8 ranks (the auto plan priced at the reference's
    constants, as ``tests/test_torch_profile.py`` does, so that both
    builtin profiles hash alike), and on the q8-ring plan with its ring
    chunk tampered to one past the quant block and to the first chunk
    whose unit-1 snap leaves the block grid: the reference's labels and
    violations, string for string."""
    from repro.launch import mesh as jax_mesh

    from repro_torch.launch import mesh

    for k in ("ICI_BW", "HBM_BW", "PEAK_FLOPS_BF16"):
        monkeypatch.setattr(mesh, k, getattr(jax_mesh, k))
    jm = jax_build_model(jax_get_config(arch).reduced())
    tm = build_model(get_config(arch).reduced())
    cases = [(policy.plan(tm, MESH8), jax_policy.plan(jm, MESH8)),
             (policy.plan(tm, MESH8, verify_tool.q8_schedule()),
              jax_policy.plan(jm, MESH8, _jax_q8_ring())),
             (policy.plan(tm, MESH8, "auto"),
              jax_policy.plan(jm, MESH8, "auto"))]
    p, r = cases[1]
    e = max(p.groups.values(), key=lambda e: e.plan.total)
    shard, block = e.plan.shard_size, e.quant_block
    bad = next(c for c in range(block + 1, 32 * block)
               if _snap_chunk(shard, c, block) != _snap_chunk(shard, c))
    for chunk in (block + 1, bad):
        cases.append((_with_chunk(p, chunk), _with_chunk(r, chunk)))
    assert verify_tool.tamper(p, "ring-chunk").invariants() == \
        _with_chunk(r, block + 1).invariants()
    with reference_analysis() as (ref_verify, _):
        for got, want in cases:
            assert _report(verify.verify_plan_static(got)) == \
                _report(ref_verify.verify_plan_static(want))
        tampered = verify.verify_plan_static(_with_chunk(p, bad))
    assert [(v.group, v.invariant) for v in tampered.errors] == \
        [(e.name, "ring_chunk")]


# --------------------------------------------------------------------------- #
# (c) the trace-backed checks in both packages
# --------------------------------------------------------------------------- #
def _ref_buffers(buffers):
    """The port's BufferTrace as the reference's ``verify_trace`` reads
    it: no jaxpr to walk (its ``no_f32_dequant`` returns early)."""
    return types.SimpleNamespace(scan_carries=buffers.scan_carries,
                                 live_peak=buffers.live_peak, _jaxpr=None)


def _global_out(out_shapes, plan):
    """Rank 0's output tree as the reference's global one: each residual
    leaf m times as long (one gathered buffer a rank)."""
    new = {}
    for name, leaf in out_shapes[0].items():
        if isinstance(leaf, dict) and "reduce_ef" in leaf:
            ef = leaf["reduce_ef"]
            m = plan.groups[name].fsdp_world
            leaf = {**leaf, "reduce_ef": dataclasses.replace(
                ef, shape=ef.shape[:-1] + (ef.shape[-1] * m,))}
        new[name] = leaf
    return (new,) + tuple(out_shapes[1:])


_TRACES = {}


def _traced(variant, n_layers=None):
    """gemma2-2b.reduced() (cut to ``n_layers``) at 8 fake ranks: the port's
    plan, the reference's and the port's trace of the plan's step (the q8
    variant's on a given batch of 8 x 32 tokens, the others on the
    default 4 x 16)."""
    key = (variant, n_layers)
    if key not in _TRACES:
        tc, jc = get_config("gemma2-2b").reduced(), \
            jax_get_config("gemma2-2b").reduced()
        if n_layers:
            tc = dataclasses.replace(tc, n_layers=n_layers)
            jc = dataclasses.replace(jc, n_layers=n_layers)
        tpol, jpol = {"default": (None, None),
                      "q8": (verify_tool.q8_schedule(), _jax_q8_ring()),
                      "keep_all": (CommSchedule(reshard_after_forward=False),
                                   JaxSchedule(reshard_after_forward=False))
                      }[variant]
        p = policy.plan(build_model(tc), MESH8, tpol)
        r = jax_policy.plan(jax_build_model(jc), MESH8, jpol)
        batch = ({"tokens": ((8, 32), torch.int64)} if variant == "q8"
                 else None)
        _TRACES[key] = (tc, p, r, trace_plan(tc, p, batch=batch))
    return _TRACES[key]


@pytest.mark.parametrize("variant", ["default", "q8"])
def test_trace_verifies_alike_in_both_packages(variant):
    """One traced step at 8 fake ranks, fed to both packages'
    ``verify_trace`` (the reference's on the reference's plan): both clean,
    the same labels; the q8 variant checks the whole invariant surface, its
    int8 codes and fp32 scales both on the ring."""
    cfg, p, r, tr = _traced(variant)
    got = verify.verify_trace(p, tr.comm, tr.buffers, tr.out_shapes)
    with reference_analysis() as (ref_verify, _):
        want = ref_verify.verify_trace(r, tr.comm, _ref_buffers(tr.buffers),
                                       _global_out(tr.out_shapes, p))
    assert got.ok and want.ok, (got.summary(), want.summary())
    assert _report(got) == _report(want)
    names = {c.split(":")[1] for c in got.checked}
    assert {"comm_missing", "comm_bytes", "wire_dtype",
            "gathered_peak"} <= names
    if variant == "q8":
        assert {"ring_chunk", "no_f32_dequant", "ef_threading"} <= names
        hops = {e.dtype for e in tr.comm.events if e.kind == "ppermute"}
        assert hops == {"int8", "float32"}
        assert not tr.buffers.conversions


# --------------------------------------------------------------------------- #
# (d) the negative paths
# --------------------------------------------------------------------------- #
_BREAK = """
import sys
from repro_torch.tools import verify_plan as v
rcs = [v.main(["--config", "gemma2-2b", "--break", m])
       for m in ("ring-chunk", "wire-bytes")]
v.tamper = lambda plan, mode: plan
rcs.append(v.main(["--config", "gemma2-2b", "--break", "wire-bytes"]))
print("RCS", *rcs)
"""


def test_break_modes_and_keep_all():
    """``--break ring-chunk`` and ``--break wire-bytes`` return 0 having
    reported a violation that names the group and the invariant, and a
    tamper that changes nothing returns 1 (the verifier must have teeth).
    A keep-all step (4 layers) verified against the plan declaring
    reshard-after-forward trips ``gathered_peak`` in both packages, and
    verifies clean against its own plan."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BREAK], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-1] == "RCS 0 0 1"
    assert "group=layers invariant=ring_chunk" in out.stdout
    assert "group=layers invariant=comm_missing" in out.stdout
    assert "group=layers invariant=wire_dtype" in out.stdout
    assert "tampered plan verified clean" in out.stderr

    cfg, keep, _, tr = _traced("keep_all", n_layers=4)
    reshard = policy.plan(build_model(cfg), MESH8)
    jreshard = jax_policy.plan(jax_build_model(dataclasses.replace(
        jax_get_config("gemma2-2b").reduced(), n_layers=4)), MESH8)
    assert verify.verify_trace(keep, tr.comm, tr.buffers,
                               tr.out_shapes).ok
    got = verify.verify_trace(reshard, tr.comm, tr.buffers, tr.out_shapes)
    with reference_analysis() as (ref_verify, _):
        want = ref_verify.verify_trace(jreshard, tr.comm,
                                       _ref_buffers(tr.buffers),
                                       _global_out(tr.out_shapes, keep))
    assert [(v.group, v.invariant) for v in got.errors] == \
        [("layers", "gathered_peak")]
    assert _report(got) == _report(want)


# --------------------------------------------------------------------------- #
# (e) the lint
# --------------------------------------------------------------------------- #
_HOT = """
    from ..quant.blockwise import quantize_blockwise

    def f(x):
        assert x is not None
        return quantize_blockwise(x, 64)
"""
_FIXTURES = {
    "src/repro/core/hot.py": _HOT,
    "src/repro/quant/ref2.py": "from .blockwise import quantize_blockwise\n",
    "src/repro_torch/core/hot.py": _HOT,
    "src/repro_torch/quant/ref2.py":
        "from .blockwise import quantize_blockwise\n",
    "src/repro_torch/kernels/k.py":
        "from ..quant.blockwise import quantize_blockwise\n",
    "src/repro_torch/launch/x.py": """
        import repro_torch.quant.blockwise as qb
        from repro.quant import blockwise
    """,
}


def _write(root, files):
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))


def _where(errs):
    return [(e.path, e.line, e.rule) for e in errs]


def test_lint_rules_agree_with_reference(tmp_path):
    """On the same fixture trees the port's ``bare-assert``,
    ``quant-blockwise`` and ``tracked-bytecode`` give the reference's
    findings (path, line, rule) -- the reference's layout (each package
    allows its own ``kernels/`` and ``quant/``, so the port's tree is held
    to the port's rule alone); ``no-reference-import`` flags JAX and
    ``repro`` imports in the port and in ``chip_smoke.py`` only; the port's
    own tree is clean under every rule."""
    _write(tmp_path, {**_FIXTURES, "x.pyc": "", "pkg/__pycache__/a.pyc": "",
                      "pkg/a.py": "A = 1\n"})
    subprocess.run(["git", "init", "-q"], cwd=tmp_path, check=True)
    subprocess.run(["git", "add", "-A"], cwd=tmp_path, check=True)
    select = ["bare-assert", "quant-blockwise", "tracked-bytecode"]
    with reference_analysis() as (_, ref_lint):
        for rule in select:
            got = lint.run_lint(tmp_path, paths=["src/repro"], select=[rule])
            want = ref_lint.run_lint(tmp_path, paths=["src/repro"],
                                     select=[rule])
            assert _where(got) == _where(want), rule
            assert got, rule
    got = _where(lint.run_lint(tmp_path, paths=["src/repro_torch"],
                               select=["quant-blockwise", "bare-assert"]))
    assert got == [("src/repro_torch/core/hot.py", 2, "quant-blockwise"),
                   ("src/repro_torch/core/hot.py", 5, "bare-assert"),
                   ("src/repro_torch/launch/x.py", 2, "quant-blockwise"),
                   ("src/repro_torch/launch/x.py", 3, "quant-blockwise")]

    _write(tmp_path, {
        "chip_smoke.py": "import jax\n",
        "src/repro_torch/bad.py": """
            import jax.numpy as jnp
            from repro.core import policy
            from .ok import x
            import repro_torch.core
        """,
        "src/other/x.py": "import jax\n"})
    got = _where(lint.run_lint(tmp_path, paths=["src", "chip_smoke.py"],
                               select=["no-reference-import"]))
    assert got == [("chip_smoke.py", 1, "no-reference-import"),
                   ("src/repro_torch/bad.py", 2, "no-reference-import"),
                   ("src/repro_torch/bad.py", 3, "no-reference-import"),
                   ("src/repro_torch/launch/x.py", 3,
                    "no-reference-import")]
    with pytest.raises(ValueError, match="unknown lint rules"):
        lint.run_lint(tmp_path, select=["compat-only"])
    assert lint.run_lint(ROOT) == []
    assert lint.main(["--root", str(ROOT)]) == 0


# --------------------------------------------------------------------------- #
# (f) the wiring on the CPU
# --------------------------------------------------------------------------- #
def test_runtime_and_train_verify_on_cpu():
    """``FSDPRuntime(verify=True)`` on a one-rank gloo group builds (its
    step traced on a meta twin), and ``train --verify`` prints a clean
    report and trains; at one rank the plan declares no comm invariant, so
    the schedules are what is proved."""
    from repro_torch.launch import train as train_cli

    cfg = get_config("gemma2-2b").reduced()
    rt = FSDPRuntime(build_model(cfg), init_local_group("gloo"),
                     device="cpu", verify=True)
    assert rt.plan.invariants() == ()
    out = train_cli.main(["--device", "cpu", "--steps", "1", "--batch", "4",
                          "--seq", "16", "--verify"])
    assert out["verify"]["errors"] == 0 and out["verify"]["warnings"] == 0
    assert out["verify"]["checked"] == len(out["groups"])
    assert np.isfinite(out["loss"]).all()


# --------------------------------------------------------------------------- #
# (g) the engine's encoder-decoder repair
# --------------------------------------------------------------------------- #
def test_engine_refuses_memory_cache_and_serves_vlm():
    """seamless-m4t-medium's cache holds the encoded frames, which only
    prefill writes: the engine, which runs decode steps only, refuses it.
    llama-3.2-vision-90b re-encodes its patches every decode step and is
    served: two requests, each its prompt streamed and 3 tokens sampled."""
    from repro_torch.serve.engine import Request, ServeEngine

    group = init_local_group("gloo")
    enc = FSDPRuntime(build_model(get_config("seamless-m4t-medium")
                                  .reduced()), group, device="cpu")
    with pytest.raises(ValueError, match="'memory' leaf"):
        ServeEngine(enc, enc.model, None)

    cfg = get_config("llama-3.2-vision-90b").reduced()
    rt = FSDPRuntime(build_model(cfg), group, device="cpu")
    params = rt.init_params(0)
    rng = np.random.default_rng(0)
    patches = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_patches, cfg.d_model)).astype(np.float32)).bfloat16()
    eng = ServeEngine(rt, rt.model, params, pool=2, max_len=16,
                      extras={"patches": patches})
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 4 + i),
                    max_new=3) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=20)
    assert all(r.done and len(r.out) == 3 for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
