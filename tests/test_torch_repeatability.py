"""The CPU reference's repeatability tools (``launch.repeatability``): two
traced CPU train steps of gemma2-2b.reduced() (fp32, 8 x 64 from
``init_params(0)``, the ``parity`` phases' set-up) repeat bitwise in one
process, the op trace records the same digest of every operator's output
on the repeat and names the first op where two traces part; the MKL call
log parser and the CPU pins ``chip_smoke.py`` sets before torch loads."""
import pytest

from repro_torch.launch import repeatability as R


@pytest.fixture(scope="module")
def runs():
    return R.streams("gemma2-2b", "cpu", [0], reps=2, trace=True)[0]


def test_op_trace_repeats_and_names_a_divergence(runs):
    """Traced, the repeat's stream and trace digest are the first's (the
    untraced repeat: tests/test_torch_train.py); a trace with one planted
    change parts from it at that op."""
    a, b = runs
    assert a["stream"] == b["stream"] and len(a["stream"]) == R.STEPS
    assert a["trace"] == b["trace"] and "ops" in a and "ops" not in b
    ops = a["ops"]
    assert len(ops) > 1000
    assert R.first_divergence(ops, ops)["op"] is None
    planted = list(ops)
    i = next(j for j, op in enumerate(ops) if op[0] == "aten.mm.default")
    planted[i] = (ops[i][0], "0" * 16, ops[i][2])
    got = R.first_divergence(planted, ops)
    assert got["index"] == i and got["op"] == "aten.mm.default"
    s = R.summary([{**a, "trace": "x", "ops": planted}, a, b])
    assert s["traces"] == {a["trace"]: 2, "x": 1}
    assert s["divergences"]["x"]["index"] == i


def test_mkl_call_log_and_cpu_pins():
    """``mkl_calls`` keeps the header and splits the calls into equal runs
    without pointers and times; ``pin_cpu`` sets what the caller left
    unset and keeps what it set."""
    log = "\n".join([
        "MKL_VERBOSE oneMKL 2024.0 Product build for Intel(R) 64",
        "MKL_VERBOSE SGEMM(N,N,4,4,4,0x1,0x2a,4) 1.5us CNR:OFF Dyn:1 NThr:8",
        "{\"0\": []}",
        "MKL_VERBOSE SGEMM(N,N,4,4,4,0x3,0x4b,4) 2.0ms CNR:OFF Dyn:1 NThr:4"])
    got = R.mkl_calls(log, 2)
    assert got["header"] == [log.splitlines()[0]]
    assert got["runs"] == [["MKL_VERBOSE SGEMM(N,N,4,4,4,p,p,4) CNR:OFF "
                            "Dyn:1 NThr:8"],
                           ["MKL_VERBOSE SGEMM(N,N,4,4,4,p,p,4) CNR:OFF "
                            "Dyn:1 NThr:4"]]
    env = {"MKL_CBWR": "COMPATIBLE"}
    pinned = R.pin_cpu(env)
    assert env["MKL_CBWR"] == "COMPATIBLE" and pinned["MKL_DYNAMIC"] == "FALSE"
    assert int(env["MKL_NUM_THREADS"]) == int(env["OMP_NUM_THREADS"]) <= 8
