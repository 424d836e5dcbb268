"""``repro_torch.launch.roofline`` and the shape registry against the
reference's (host arithmetic only, nothing compiled).

Parity classes: ``model_flops``, ``active_params``, ``total_params`` and
``supports_shape`` EQUAL the reference's (the same floats) for every
ported config x ``SHAPES``; ``supports_shape`` also on the reference's
twelve config objects; the collective volume rule equal to what the
reference's ``parse_collectives`` reads from HLO lines of the same
collectives; ``Roofline.row()`` has the reference's keys, its times the
H100 constants of ``launch.mesh``.
"""
import dataclasses

import pytest

from repro_torch.configs import (ARCH_IDS, ASSIGNED_ARCH_IDS, SHAPES,
                                 ShapeConfig, get_config, supports_shape)
from repro_torch.launch import roofline


def test_shapes_and_assigned_ids_are_the_reference():
    from repro.configs import ASSIGNED_ARCH_IDS as ref_ids
    from repro.configs.base import SHAPES as ref_shapes

    assert ASSIGNED_ARCH_IDS == ref_ids
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_shapes.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.configs import supports_shape as ref_supports
    from repro.configs.base import SHAPES as ref_shapes
    from repro.launch import roofline as ref

    cfg, rcfg = get_config(arch), ref_config(arch)
    assert roofline.active_params(cfg) == ref.active_params(rcfg)
    assert roofline.total_params(cfg) == ref.total_params(rcfg)
    for name, shape in SHAPES.items():
        assert roofline.model_flops(cfg, shape) == \
            ref.model_flops(rcfg, ref_shapes[name])
        assert supports_shape(cfg, shape) == ref_supports(rcfg,
                                                          ref_shapes[name])


def test_supports_shape_on_every_reference_config():
    """The port's rule on all twelve reference configs (the four families
    the port lacks included) is the reference's."""
    from repro.configs import ARCH_IDS as ref_ids
    from repro.configs import get_config as ref_config
    from repro.configs import supports_shape as ref_supports
    from repro.configs.base import SHAPES as ref_shapes

    for arch in ref_ids:
        rcfg = ref_config(arch)
        for name in SHAPES:
            assert supports_shape(rcfg, SHAPES[name]) == \
                ref_supports(rcfg, ref_shapes[name]), (arch, name)


def test_unported_families_raise_naming_14b():
    """No assigned family is left unported: every assigned id builds its
    config, field for field the reference's."""
    from repro.configs import get_config as ref_config

    for arch in ASSIGNED_ARCH_IDS:
        assert arch in ARCH_IDS
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(ref_config(arch))


def test_collective_volume_is_the_reference_rule():
    """The same collectives as HLO lines through the reference's parser
    and as (kind, group size, largest buffer) through the port's."""
    from repro.launch.roofline import parse_collectives

    hlo = "\n".join([
        "%a = bf16[8,1024]{1,0} all-gather(bf16[1,1024]{1,0} %x), "
        "replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}",
        "%b = f32[128]{0} reduce-scatter(f32[1024]{0} %y), "
        "replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}",
        "%c = f32[2]{0} all-reduce(f32[2]{0} %z), "
        "replica_groups=[2,4]<=[8]",
        "%d = bf16[4,64]{1,0} all-to-all(bf16[4,64]{1,0} %w), "
        "replica_groups={{0,1,2,3}}, dimensions={0}",
    ])
    ref = parse_collectives(hlo)
    port = roofline.collective_stats([
        ("all-gather", 8, 8 * 1024 * 2), ("reduce-scatter", 8, 1024 * 4),
        ("all-reduce", 4, 2 * 4), ("all-to-all", 4, 4 * 64 * 2)])
    assert port.counts == ref.counts
    assert port.bytes_by_kind == pytest.approx(ref.bytes_by_kind)
    assert port.total_bytes == pytest.approx(ref.total_bytes)
    assert roofline.collective_volume("all-gather", 1, 100) == 0.0
    assert roofline.collective_volume("collective-permute", 4, 100) == 100


def test_roofline_row_keys_and_h100_terms():
    from repro.launch.roofline import Roofline as RefRoofline
    from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

    kw = dict(arch="a", shape="train_4k", mesh="pod16x16", chips=256,
              compile_ok=True, flops_per_device=3e15, bytes_per_device=2e12,
              collective_bytes=4e11, temp_bytes=1e9, arg_bytes=2e9,
              coll_counts={"all-gather": 3}, model_flops=5e17,
              gather_wire_bytes=1e8, reduce_wire_bytes=2e8)
    r = roofline.Roofline(**kw)
    ref = RefRoofline(**kw)
    assert list(r.row()) == list(ref.row())
    assert r.t_compute == 3e15 / PEAK_FLOPS_BF16 == 3e15 / 989e12
    assert r.t_memory == 2e12 / HBM_BW
    assert r.t_collective == 4e11 / ICI_BW
    assert r.dominant == "compute"
    same = ("hlo_gflops_dev", "hbm_gb_dev", "coll_gb_dev", "temp_gb_dev",
            "arg_gb_dev", "gather_wire_mb", "reduce_wire_mb",
            "model_gflops", "useful_ratio", "colls", "ok")
    assert {k: r.row()[k] for k in same} == {k: ref.row()[k] for k in same}


def test_mfu():
    """MFU = model FLOPs / (step seconds x the card's dense bf16 peak);
    gemma2-2b at 4 layers, 2 x 2048: 6 x 1,491,075,072 x 4,096 FLOPs."""
    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=4)
    shape = ShapeConfig("train", 2048, 2, "train")
    assert roofline.active_params(cfg) == 1_491_075_072
    assert roofline.model_flops(cfg, shape) == 6.0 * 1_491_075_072 * 4096
    assert roofline.mfu(cfg, shape, 0.1952) == pytest.approx(
        6.0 * 1_491_075_072 * 4096 / (0.1952 * 989e12))
