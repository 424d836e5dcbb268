"""The training command, ``python -m repro_torch.launch.train``, against the
reference's ``python -m repro.launch.train`` with the same arguments
(gemma2-2b.reduced(), AdamW, bf16 compute as both configs default, 3 steps
of 8 x 32, every step logged): on one rank in process and on 2 gloo ranks
(``--data 2``) against the reference on 2 host devices, each in a
subprocess; its checkpoint and ``--resume``; ``--verify`` and the default
device without a card.

Parity classes (bounds with the measured readings beside them):
  * the printed ``loss`` and ``gnorm`` against the reference's: the bf16
    compute class of tests/test_torch_train.py (loss 5e-3, grad norm 3e-2
    relative; measured 3.8e-4 and 1.8e-3 on one rank, 2.7e-4 and 1.8e-3
    on 2);
  * a resumed run against the uninterrupted one: BITWISE.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train as train_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--steps", "3", "--batch", "8", "--seq", "32", "--log-every", "1"]
STEP = re.compile(r"^step +(\d+) loss ([0-9.]+) gnorm ([0-9.]+) tok/s")
BOUND = {"loss": 5e-3, "gnorm": 3e-2}


def _run(cmd, env):
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT)


def _steps(text: str) -> list:
    """(step, loss, gnorm) of each ``step`` line printed."""
    return [(int(m[1]), float(m[2]), float(m[3]))
            for m in map(STEP.match, text.splitlines()) if m]


@pytest.fixture(scope="module")
def printed():
    """The reference's output on 1 and 2 host devices and the port's on 2
    gloo ranks, each in a subprocess, all started at once."""
    base = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    base["PYTHONPATH"] = os.path.join(ROOT, "src")
    ref_env = dict(base, JAX_PLATFORMS="cpu")
    procs = {
        "ref1": _run([sys.executable, "-m", "repro.launch.train", *ARGS],
                     ref_env),
        "ref2": _run([sys.executable, "-m", "repro.launch.train", *ARGS,
                      "--data", "2"],
                     dict(ref_env, XLA_FLAGS="--xla_force_host_platform_"
                                             "device_count=2")),
        "port2": _run([sys.executable, "-m", "repro_torch.launch.train",
                       *ARGS, "--data", "2", "--device", "cpu"], base)}
    out = {}
    for name, p in procs.items():
        text, err = p.communicate(timeout=300)
        assert p.returncode == 0, (name, err[-3000:])
        out[name] = text
    return out


def _others(text: str) -> list:
    """The printed lines other than the step lines: the plan's
    ``describe()`` table and the ``arch=`` line."""
    return [ln for ln in text.splitlines() if not STEP.match(ln)]


def _held(got, want):
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == [0, 1, 2]
    for (_, loss, gnorm), (_, rl, rg) in zip(got, want):
        assert loss == pytest.approx(rl, rel=BOUND["loss"]), (loss, rl)
        assert gnorm == pytest.approx(rg, rel=BOUND["gnorm"]), (gnorm, rg)


def test_train_command_matches_reference(printed, capsys):
    """One rank in process: the plan's ``describe()`` table and the
    ``arch=`` line the same text as the reference's, and each step's loss
    and grad norm within the bf16 class of the reference's."""
    res = train_cli.main([*ARGS, "--device", "cpu"])
    out = capsys.readouterr().out
    ref = printed["ref1"]
    assert _others(out) == _others(ref) and len(_others(ref)) >= 4
    _held(_steps(out), _steps(ref))
    assert [f"{x:.4f}" for x in res["loss"]] == \
        [f"{loss:.4f}" for _, loss, _ in _steps(out)]


def test_train_command_on_two_ranks_matches_reference(printed):
    """``--data 2`` on 2 gloo ranks (rank 0 prints) against the reference
    on 2 host devices: the same plan table and ``arch=`` line
    (``mesh={'data': 2, 'model': 1}``) and streams within the bf16
    class."""
    port, ref = printed["port2"], printed["ref2"]
    assert _others(port) == _others(ref)
    assert any("'data': 2" in ln for ln in _others(ref))
    _held(_steps(port), _steps(ref))


def test_checkpoint_and_resume_are_bitwise(tmp_path, capsys):
    """``--ckpt D --ckpt-every 2 --steps 4``, then ``--resume --steps 6``:
    the resumed steps 4 and 5 are bitwise the uninterrupted run's."""
    d = str(tmp_path / "ck")
    base = ["--batch", "8", "--seq", "32", "--log-every", "1",
            "--device", "cpu"]
    first = train_cli.main([*base, "--steps", "4", "--ckpt", d,
                            "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert f"checkpoint @ step 2 -> {d}" in out
    assert f"checkpoint @ step 4 -> {d}" in out
    assert f"final checkpoint -> {d}" in out
    resumed = train_cli.main([*base, "--steps", "6", "--ckpt", d,
                              "--resume"])
    assert f"resumed {d} @ step 4" in capsys.readouterr().out
    whole = train_cli.main([*base, "--steps", "6"])
    assert resumed["start"] == 4 and len(resumed["loss"]) == 2
    assert first["loss"] == whole["loss"][:4]
    assert resumed["loss"] == whole["loss"][4:]
    assert resumed["grad_norm"] == whole["grad_norm"][4:]


def test_train_command_refusals():
    """``--verify`` proves the plan before the first step (no step here:
    ``--steps 0``) and reports clean; ``--tp 2`` goes through
    ``configs.with_tp``; without a card the default device raises before
    any rank is spawned."""
    out = train_cli.main(["--verify", "--device", "cpu", "--steps", "0"])
    assert out["verify"]["errors"] == 0 and out["loss"] == []
    cfg = train_cli.train_config(train_cli.parse_args(["--tp", "2"]))
    assert cfg.parallel.tp == 2 and "model" not in cfg.parallel.fsdp_axes
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--data", "2"])
