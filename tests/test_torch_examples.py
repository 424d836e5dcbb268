"""The port's five examples (``repro_torch.examples``) against the
reference's (``examples/``), both on the CPU from the same seeds.

The reference's example modules are loaded from their files and run as
they are; only their step count (the module's ``STEPS``) and, for the
serve examples' token check, their runtime's compute dtype are set from
here.

Classes:
  * train streams (quickstart's AdamW, 8-bit Adam, Muon) at the examples'
    bf16 compute: the bf16 stream class of ``tests/test_torch_train.py``
    (loss rtol 5e-3, grad norm 3e-2);
  * served tokens: equal at fp32 compute.  At the examples' bf16 compute
    two logits that round to neighbouring bf16 values can flip a greedy
    token, after which the streams part (measured: serve_moe's request 2
    at its fourth token, continuous_batching's requests 3 and 4 at their
    first and fourth), so the port's bf16 runs are held to the
    reference's requests and token counts only.
"""
import functools
import importlib.util
import pathlib
import re

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL, GNORM_RTOL = 5e-3, 3e-2
TRAIN_STEPS = 3


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fp32_runtime(monkeypatch, mod):
    import jax.numpy as jnp

    monkeypatch.setattr(mod, "FSDPRuntime", functools.partial(
        mod.FSDPRuntime, compute_dtype=jnp.float32))


def test_quickstart(capsys):
    """The plan lines string-equal; the printed loss and grad-norm streams
    within the bf16 class."""
    from repro_torch.examples import quickstart

    got = quickstart.main(["--device", "cpu"])
    port_out = capsys.readouterr().out
    _reference("quickstart").main()
    ref_out = capsys.readouterr().out
    assert [l for l in port_out.splitlines() if l.startswith("group")] == \
        [l for l in ref_out.splitlines() if l.startswith("group")]
    rows = re.findall(r"step +(\d+)  loss ([\d.]+)  grad_norm ([\d.]+)",
                      ref_out)
    assert [int(r[0]) for r in rows] == [0, 5, 10, 15, 19]
    for i, loss, gnorm in rows:
        np.testing.assert_allclose(got["loss"][int(i)], float(loss),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"][int(i)], float(gnorm),
                                   rtol=GNORM_RTOL)
    assert re.findall(r"step +\d+  loss", port_out) == \
        re.findall(r"step +\d+  loss", ref_out)


@pytest.mark.parametrize("name,opt,args", [
    ("train_8bit_adam", "adam8bit", ()),
    ("muon_demo", "muon", (3e-3,)),
])
def test_train_example_streams(monkeypatch, name, opt, args):
    """The port's ``main`` (its table printed, the example's own check
    passed) returns both loss streams over the first steps; the example's
    own optimizer's stream is within the bf16 class of the reference's
    ``run`` (its AdamW stream runs the path ``test_quickstart`` holds)."""
    port = importlib.import_module(f"repro_torch.examples.{name}")
    ref = _reference(name)
    monkeypatch.setattr(ref, "STEPS", TRAIN_STEPS)
    got = port.main(["--device", "cpu", "--steps", str(TRAIN_STEPS)])
    assert list(got) == ["adamw", opt]
    assert all(len(v) == TRAIN_STEPS for v in got.values())
    np.testing.assert_allclose(got[opt], ref.run(opt, *args),
                               rtol=LOSS_RTOL)


def _tokens(pattern, text):
    return {int(k): [int(t) for t in v.split(",")]
            for k, v in re.findall(pattern, text)}


@pytest.mark.parametrize("name,pattern", [
    ("serve_moe", r"request\[(\d+)\] -> \[([\d, ]+)\]"),
    ("continuous_batching", r"req\[(\d+)\] prompt_len= *\d+ -> \[([\d, ]+)\]"),
])
def test_serve_example_tokens(monkeypatch, capsys, name, pattern):
    """Greedy tokens of every request equal the reference's at fp32
    compute; at the examples' bf16 compute, the same requests and token
    counts."""
    port = importlib.import_module(f"repro_torch.examples.{name}")
    ref = _reference(name)
    _fp32_runtime(monkeypatch, ref)
    ref.main()
    want = _tokens(pattern, capsys.readouterr().out)
    port.main(["--device", "cpu", "--compute-dtype", "float32"])
    assert _tokens(pattern, capsys.readouterr().out) == want
    port.main(["--device", "cpu"])
    bf16 = _tokens(pattern, capsys.readouterr().out)
    assert {k: len(v) for k, v in bf16.items()} == \
        {k: len(v) for k, v in want.items()} and len(want) >= 4


def test_examples_default_to_the_card():
    """Without a card an example raises unless given ``--device cpu``."""
    import torch

    from repro_torch.examples import serve_moe

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_moe.main([])
