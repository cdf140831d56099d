"""The port's config mirrors the JAX package's: field names, defaults,
presets and ROS-parameter parsing are equal."""

import dataclasses

import pytest

import neo_mpc_planner2_tpu.config as jcfg
import neo_mpc_planner2_tpu_torch.config as tcfg


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("cls", ["MpcConfig", "CompatConfig"])
def test_fields_and_defaults_equal(cls):
    jf = {f.name: f for f in dataclasses.fields(getattr(jcfg, cls))}
    tf = {f.name: f for f in dataclasses.fields(getattr(tcfg, cls))}
    assert list(jf) == list(tf)
    assert _as_dict(getattr(jcfg, cls)()) == _as_dict(getattr(tcfg, cls)())


@pytest.mark.parametrize("preset", ["default_config", "fleet_config",
                                    "product_config"])
def test_presets_equal(preset):
    assert _as_dict(getattr(jcfg, preset)()) == _as_dict(
        getattr(tcfg, preset)())


def test_derived_properties_equal():
    for preset in ("default_config", "fleet_config"):
        j, t = getattr(jcfg, preset)(), getattr(tcfg, preset)()
        assert (j.dt, j.control_interval, j.footprint_mode) == (
            t.dt, t.control_interval, t.footprint_mode)


@pytest.mark.parametrize("with_base", [False, True])
def test_config_from_ros_params_equal(with_base):
    params = {"acc_x_limit": 2.5, "max_vel_x": "0.7", "opt_tolerance": "1e-3",
              "control_steps": "5", "w_costmap": 0.05,
              "lookahead_dist_min": 0.4, "not_a_parameter": 1,
              "compat": "ignored"}
    jb = jcfg.fleet_config() if with_base else None
    tb = tcfg.fleet_config() if with_base else None
    assert _as_dict(jcfg.config_from_ros_params(params, jb)) == _as_dict(
        tcfg.config_from_ros_params(params, tb))
