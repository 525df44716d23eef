"""The PyTorch port's configuration against the JAX package's: same fields,
defaults and derived properties, and SdfConfig and SoftConfig carried
across by ``from_dict(asdict(...))``."""

import dataclasses

import pytest

import chaq_sdfgen_tpu.config as jcfg
import chaq_sdfgen_tpu_torch.config as tcfg


def _value(v):
    return getattr(v, "value", v)


@pytest.mark.parametrize("name", ["SdfConfig", "SoftConfig", "ShardingConfig"])
def test_fields_and_defaults_match(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(jf, tf):
        assert _value(b.default) == _value(a.default), a.name
    assert getattr(tcfg, name).__dataclass_params__.frozen


@pytest.mark.parametrize("name", ["Algorithm", "Channel"])
def test_enums_match(name):
    assert [m.value for m in getattr(tcfg, name)] == [m.value for m in getattr(jcfg, name)]


CONFIGS = [
    {},
    {"spread": 1},
    {"spread": 100, "asymmetric": True, "channel": "luminance"},
    {"spread": 300, "invert": True, "band": 400},
    {"spread": 7, "channel": "alpha", "algorithm": "jfa", "jfa_plus_one": False},
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_derived_properties_match(kw):
    j = jcfg.SdfConfig(**kw)
    t = tcfg.SdfConfig(**kw)
    assert t.effective_band == j.effective_band
    assert t.channel_offset == j.channel_offset


@pytest.mark.parametrize("kw", CONFIGS)
def test_from_dict_round_trips(kw):
    j = jcfg.SdfConfig(**kw)
    t = tcfg.SdfConfig.from_dict(dataclasses.asdict(j))
    assert {k: _value(v) for k, v in dataclasses.asdict(t).items()} == {
        k: _value(v) for k, v in dataclasses.asdict(j).items()
    }
    assert tcfg.SdfConfig.from_dict(dataclasses.asdict(t)) == t


def test_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError):
        tcfg.SdfConfig.from_dict({"spread": 3, "sharpness": 1})


SOFT_CONFIGS = [
    {},
    {"tau": 2.0, "temperature": 1.0},
    {"tau": 4.0, "temperature": 1.5, "eps": 1e-8, "clamp": "tanh", "gray_range": (-10.0, 300.0)},
    {"clamp": "none", "gray_range": None},
]


@pytest.mark.parametrize("kw", SOFT_CONFIGS)
def test_soft_from_dict_round_trips(kw):
    j = jcfg.SoftConfig(**kw)
    t = tcfg.SoftConfig.from_dict(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tcfg.SoftConfig.from_dict(dataclasses.asdict(t)) == t
    # JSON hands a range back as a list; it comes back as a tuple
    d = dataclasses.asdict(j)
    if d["gray_range"] is not None:
        d["gray_range"] = list(d["gray_range"])
    assert tcfg.SoftConfig.from_dict(d) == t and tcfg.SoftConfig.from_dict(d).gray_range == t.gray_range


def test_soft_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError):
        tcfg.SoftConfig.from_dict({"tau": 1.0, "precision": "high"})


def test_spread_validation_matches():
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            mod.SdfConfig(spread=0)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"mesh_shape": (2, 4), "axis_names": ("y", "x")},
        {"mesh_shape": (2, 2, 2), "axis_names": ("data", "y", "x"), "data_axis": "data"},
        {"mesh_shape": (4, 1), "axis_names": ("y", "x"), "halo_impl": "rdma"},
    ],
)
def test_sharding_axes_match(kw):
    j = jcfg.ShardingConfig(**kw)
    t = tcfg.ShardingConfig(**kw)
    assert (t.y_axis, t.x_axis) == (j.y_axis, j.x_axis)


@pytest.mark.parametrize(
    "kw",
    [
        {"mesh_shape": (2,), "axis_names": ("y", "x")},
        {"halo_impl": "nccl"},
        {"data_axis": "data"},
    ],
)
def test_sharding_validation_matches(kw):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            mod.ShardingConfig(**kw)


def test_build_mesh_waits_for_multi_gpu_tier(monkeypatch):
    """build_mesh makes the mesh now (the sharded hard tier): logical CPU
    shards on request, else the visible cards, raising when too few."""
    import torch

    m = tcfg.ShardingConfig((2, 2), ("y", "x")).build_mesh("cpu")
    assert m.shape == {"y": 2, "x": 2} and all(d.type == "cpu" for d in m.devices.flat)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        tcfg.ShardingConfig().build_mesh()
