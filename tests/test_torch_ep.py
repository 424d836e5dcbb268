"""Expert parallelism on gloo meshes: qwen3-moe-235b-a22b.reduced() (4
experts, top 2) with AdamW, 3 fp32 steps of a 4 x 32 batch, at ep 2 on
data 1 x model 2 and data 2 x model 2 -- the experts split over the model
axis on their expert dim, the tokens exchanged by two all-to-alls --
against the reference on as many host devices (a JAX subprocess with 4)
with the batch over ``("data", "model")``, and with the batch over
``data`` alone (every rank of the model axis the same tokens; AdamW and
SGD) against the port's one-rank runs.

Parity classes (bounds with the measured readings beside them):
  * batch over ``data`` against one rank: ALLCLOSE, fp32 rounding (each
    expert sees every token twice, once from each model rank, and the port
    counts each once);
  * batch over ``("data", "model")`` against the reference: ALLCLOSE,
    fp32 rounding and the MoE class of tests/test_torch_moe.py (routing
    identical unless router probabilities tie within rounding);
  * the reference with the batch over ``data`` alone sums each replica's
    gradient once per model rank (its grad norm twice its one-device
    norm at ep 2; ROADMAP Queue 3);
  * ``init_params`` and ``load_reference_state`` of the outer-split expert
    group: BITWISE.
"""
import os

import numpy as np
import pytest

import _torch_mesh_worker as MW
from repro_torch.launch.mesh import init_local_group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = "qwen3-moe-235b-a22b"
DM, D = ("data", "model"), ("data",)
FIELDS = {"optimizer": "adamw"}
# the batch over ``data`` against one rank under SGD too, whose masters
# move by lr times the gradient (``test_ep_batch_over_data_sgd_...``)
SGD = {"optimizer": "sgd"}
# AdamW's masters against one rank leave out the elements whose one-rank
# gradient, at some step, is not 0 and below ROUNDING_ULPS fp32 ulps of
# its row's largest (the last axis): the sum that made it rounds at that
# scale, and AdamW's step is about lr x sign(g) whatever |g| is
ROUNDING_ULPS = 2

RUNS2 = {"ep2": (1, 2, MOE, dict(fsdp_axes=DM, batch_axes=DM, ep=2),
                 FIELDS, None),
         "ep2_batch_data": (1, 2, MOE, dict(fsdp_axes=DM, batch_axes=D,
                                            ep=2), FIELDS, None)}
RUNS2_SGD = {"ep2_batch_data_sgd": (1, 2, MOE, dict(
    fsdp_axes=DM, batch_axes=D, ep=2), SGD, None)}
RUNS4 = {"ep2_data2": (2, 2, MOE, dict(fsdp_axes=DM, batch_axes=DM, ep=2),
                       FIELDS, None)}
REF_RUNS = {"one": (1, 1, MOE, dict(fsdp_axes=D, batch_axes=D), FIELDS,
                    None), **RUNS2, **RUNS4}


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    ref_out = str(tmp / "ref.npz")
    ref = MW.start_reference(os.path.join(ROOT, "src"), ref_out, REF_RUNS,
                             init=["ep2"])
    p2 = MW.spawn(2, tmp, {**RUNS2, **RUNS2_SGD}, init=["ep2"],
                  ref_init=ref_out + ".init")
    p4 = MW.spawn(4, tmp, RUNS4)
    group = init_local_group("gloo")
    one = MW.run(group, MW.config(MOE, dict(fsdp_axes=D, batch_axes=D),
                                  **FIELDS), keep_grads=True)
    one_sgd = MW.run(group, MW.config(MOE, dict(fsdp_axes=D, batch_axes=D),
                                      **SGD))
    o2, o4 = MW.join(*p2), MW.join(*p4)
    assert ref.wait(timeout=300) == 0
    data = dict(np.load(ref_out))
    return {"port": {**MW.runs_of(o2, {**RUNS2, **RUNS2_SGD}),
                     **MW.runs_of(o4, RUNS4)},
            "one": {k: v for k, v in one.items() if not k.startswith("grad")},
            "one_grads": {k: v for k, v in one.items()
                          if k.startswith("grad")},
            "one_sgd": one_sgd,
            "ref": {n: {k.split("/", 1)[1]: v for k, v in data.items()
                        if k.startswith(n + "/")} for n in REF_RUNS},
            "ranks2": o2, "ref_init": dict(np.load(ref_out + ".init"))}


def rounding_elements(grads: dict, name: str) -> np.ndarray:
    """Where ``name``'s one-rank gradient, at some step, is not 0 and below
    ROUNDING_ULPS fp32 ulps of its row's largest."""
    g = np.abs(np.stack([v for k, v in sorted(grads.items())
                         if k.split("/", 1)[1] == name]))
    row = g.max(axis=-1, keepdims=True)
    eps = np.finfo(np.float32).eps
    return ((g > 0) & (g < ROUNDING_ULPS * eps * row)).any(axis=0)


def test_ep_batch_over_data_matches_one_rank(streams):
    """AdamW, as the configs train.  Each expert sees every token twice and
    counts it once: the one-rank stream.  AdamW's step is about lr x
    sign(g) at a fresh element whatever |g| is, so a gradient that sums
    to fp32 rounding takes either sign: such elements (``rounding_elements``:
    14 of 3.94 M here: one in ``emb``, four in ``head``, nine in the
    attention and expert weights) are left out of the masters.  Measured: losses
    6.0e-8, grad norms 2.6e-7; masters over every element 1.8e-8 but
    ``emb`` 2.1e-5, which is one element: row 29 (a token first seen at
    step 2, its row's largest gradient 0.835) at column 199, gradient
    1.4e-7, under 2 ulps of 0.835, moved 3.3e-4 apart; the next rows
    differ by at most 1.3e-7 (row 365, largest gradient 1.6e-5) and 7.1e-8
    (row 319).  With those 14 left out: ``emb`` 1.4e-8, masters 1.8e-8."""
    got, want = streams["port"]["ep2_batch_data"], streams["one"]
    np.testing.assert_allclose(got["metrics"][:, 0], want["metrics"][:, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(got["metrics"][:, 1], want["metrics"][:, 1],
                               rtol=1e-5)
    for k, v in want.items():
        if k != "metrics":
            keep = ~rounding_elements(streams["one_grads"], k)
            assert MW.rel_l2(got[k][keep], v[keep]) < 1e-6, (
                k, MW.rel_l2(got[k][keep], v[keep]))


def test_ep_batch_over_data_sgd_matches_one_rank(streams):
    """The same under SGD, whose masters move by lr times the gradient: a
    gradient off by a factor moves them by that factor, and every element
    is held.  Measured: losses and grad norms 6.7e-8, masters under
    1e-7."""
    got, want = streams["port"]["ep2_batch_data_sgd"], streams["one_sgd"]
    np.testing.assert_allclose(got["metrics"][:, 0], want["metrics"][:, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(got["metrics"][:, 1], want["metrics"][:, 1],
                               rtol=1e-5)
    for k, v in want.items():
        if k != "metrics":
            assert MW.rel_l2(got[k], v) < 1e-6, (k, MW.rel_l2(got[k], v))


@pytest.mark.parametrize("name", ["ep2", "ep2_data2"])
def test_ep_matches_reference(name, streams):
    """Batch over ``("data", "model")``, as the production configs shard
    it: each rank routes its own tokens, with its own expert capacity.
    Measured (ep2, ep2_data2): losses 1.2e-7 and 1.1e-7, grad norms
    5.4e-7 and 1.3e-7, masters 2.8e-7 and 6.9e-7."""
    got, ref = streams["port"][name], streams["ref"][name]
    np.testing.assert_allclose(got["metrics"][:, 0], ref["metrics"][:, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(got["metrics"][:, 1], ref["metrics"][:, 1],
                               rtol=5e-6)
    for k, v in ref.items():
        if k != "metrics":
            assert MW.rel_l2(got[k], v) < 5e-6, (k, MW.rel_l2(got[k], v))


def test_reference_ep_gradient_factor(streams):
    """ROADMAP Queue 3: the reference with the batch over ``data`` alone
    has its one-device loss and twice its grad norm at ep 2 (the port:
    its one-rank norm)."""
    one = streams["ref"]["one"]["metrics"][0]
    ref = streams["ref"]["ep2_batch_data"]["metrics"][0]
    assert ref[0] == pytest.approx(one[0], rel=1e-6)
    assert ref[1] / one[1] == pytest.approx(2.0, rel=1e-5)
    port = streams["port"]["ep2_batch_data"]["metrics"][0]
    assert port[1] == pytest.approx(streams["one"]["metrics"][0][1],
                                    rel=1e-6)


def test_expert_group_init_and_load_bitwise(streams):
    """ep 2: each rank's ``layers_experts`` block is its outer row (half of
    the experts) of the reference's global buffer, from ``init_params``
    and from ``load_reference_state``; the other groups are FSDP shards
    over both axes."""
    ref = streams["ref_init"]
    for r, o in enumerate(streams["ranks2"]):
        for g in ("layers", "layers_experts", "globals"):
            glob = ref[f"init/ep2/{g}/master"]
            n = glob.shape[-1] // 2
            want = glob[..., r * n:(r + 1) * n]
            for key in (f"init/ep2/{g}", f"load/ep2/{g}/master"):
                assert np.array_equal(o[key].view(np.int32),
                                      want.view(np.int32)), (key, r)
