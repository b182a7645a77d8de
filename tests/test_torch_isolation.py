"""The port stands alone: it imports neither JAX, flax nor `captra_tpu`, its
entry points refuse to run quietly on the CPU, and the options it does not
carry yet raise instead of being ignored."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from captra_tpu_torch.config import get_config, schema
from captra_tpu_torch.config.presets import NOCS_BOTTLE_OVERRIDES, nocs_bottle
from captra_tpu_torch.models.coordnet import CoordNet
from captra_tpu_torch.models.rotnet import RotNet
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking.tracker import make_track_step, track_trajectory
from captra_tpu_torch.training.convert import coordnet_from_flax
from tests.torch_port_helpers import tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "captra_tpu_torch")
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|flax|captra_tpu)(?:\.|\s|$)", re.M)


def _sources():
    for base, dirs, files in os.walk(PKG):
        if "_build" in dirs:       # build output, not source
            dirs.remove("_build")
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_import_pulls_in_no_jax():
    code = (
        "import pkgutil, importlib, sys, captra_tpu_torch\n"
        "for m in pkgutil.walk_packages(captra_tpu_torch.__path__,\n"
        "                               'captra_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'flax', 'captra_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_import_no_jax():
    files = list(_sources())
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hit = _FORBIDDEN.search(f.read())
        assert hit is None, f"{path} imports {hit.group(1)}"


def test_forbidden_pattern_catches_imports():
    for line in ("import jax", "from jax import numpy", "import flax.linen",
                 "from captra_tpu.ops import fps", "  import captra_tpu"):
        assert _FORBIDDEN.search(line), line
    for line in ("import captra_tpu_torch", "from captra_tpu_torch import x",
                 "import jaxlib_free"):
        assert not _FORBIDDEN.search(line), line


def _entry_points(cfg):
    return {
        "CoordNet": lambda: CoordNet(cfg),
        "RotNet": lambda: RotNet(cfg),
        "make_track_step": lambda: make_track_step(cfg, None, None),
        "track_trajectory": lambda: track_trajectory(
            None, Pose.identity((1, 1)), {"points": np.zeros((2, 1, 8, 3))}),
        "coordnet_from_flax": lambda: coordnet_from_flax(cfg, {}),
    }


@pytest.mark.parametrize("name", sorted(_entry_points(None)))
def test_entry_points_need_cuda_or_an_explicit_device(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(tiny_config(schema))[name]()


_UNPORTED_TRACK = {
    "track_cfg/motion_model": dict(motion_model="const_vel"),
    "track_cfg/refine_iters": dict(refine_iters=2),
    "track_cfg/conf_weighted_delta": dict(conf_weighted_delta=True),
    "track_cfg/rot_fit": dict(rot_fit="npcs"),
    "track_cfg/delta_gain": dict(delta_gain=1.5),
    "track_cfg/scale_clamp": dict(scale_clamp=0.1),
    "track_cfg/fit_ransac": dict(fit_ransac=8),
}


@pytest.mark.parametrize("field", sorted(_UNPORTED_TRACK))
def test_unported_track_options_raise(field):
    cfg = tiny_config(schema)
    cfg = cfg.replace(track=dataclasses.replace(cfg.track,
                                                **_UNPORTED_TRACK[field]))
    with pytest.raises(NotImplementedError, match=re.escape(field)):
        make_track_step(cfg, None, None, device="cpu")


@pytest.mark.parametrize("net_cls", [CoordNet, RotNet])
@pytest.mark.parametrize("field,value", [("compute_dtype", "bfloat16"),
                                         ("basin_head", True)])
def test_unported_network_options_raise(net_cls, field, value):
    cfg = tiny_config(schema)
    cfg = cfg.replace(network=dataclasses.replace(cfg.network,
                                                  **{field: value}))
    with pytest.raises(NotImplementedError, match=f"network/{field}"):
        net_cls(cfg, device="cpu")


def test_code_built_bottle_config_equals_yaml():
    built = nocs_bottle()
    loaded = get_config("config_track.yml", overrides=NOCS_BOTTLE_OVERRIDES)
    for f in dataclasses.fields(schema.Config):
        assert getattr(built, f.name) == getattr(loaded, f.name), f.name
    assert built == loaded
    assert built.obj.sym and built.obj.num_parts == 1
    assert built.num_points == 4096
    assert built.pointnet == schema.PointNetCfg()
