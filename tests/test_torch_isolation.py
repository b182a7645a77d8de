"""The port stands alone: it imports neither JAX, flax, optax, orbax,
`captra_tpu` nor OpenCV (the card's machine has none: the readers decode
PNGs themselves), and its entry points refuse to run quietly on the
CPU."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from captra_tpu_torch.cli import eval_checkpoint_track as eval_ckpt_cli
from captra_tpu_torch.cli import evaluate as evaluate_cli
from captra_tpu_torch.cli import finetune as finetune_cli
from captra_tpu_torch.cli import flagship_demo as flagship_cli
from captra_tpu_torch.cli import gtless_init_probe as probe_cli
from captra_tpu_torch.cli import init_search_scorer_diag as diag_cli
from captra_tpu_torch.cli import rollout_finetune as rollout_cli
from captra_tpu_torch.cli import smoke_train_track as smoke_cli
from captra_tpu_torch.cli import sym_pwm_ablation as pwm_cli
from captra_tpu_torch.cli import track as track_cli
from captra_tpu_torch.cli import train as train_cli
from captra_tpu_torch.cli import train_basin_head as basin_cli
from captra_tpu_torch.config import get_config, schema
from captra_tpu_torch.config.presets import NOCS_BOTTLE_OVERRIDES, nocs_bottle
from captra_tpu_torch.eval.evaluator import evaluate_results_dir
from captra_tpu_torch.models.coordnet import CoordNet
from captra_tpu_torch.models.rotnet import RotNet
from captra_tpu_torch.parallel import mesh
from captra_tpu_torch.parallel.dryrun import dryrun_multichip
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking.tracker import (
    init_pose_from_cloud, make_track_step, search_init_orientation,
    track_trajectory,
)
from captra_tpu_torch.training.convert import coordnet_from_flax
from captra_tpu_torch.training.rollout import (
    collect_states, make_finetune_round,
)
from captra_tpu_torch.training.trainer import Trainer
from tests.torch_port_helpers import tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "captra_tpu_torch")
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|flax|optax|orbax|captra_tpu|cv2)"
    r"(?:\.|\s|$)",
    re.M)


def _sources():
    for base, dirs, files in os.walk(PKG):
        if "_build" in dirs:       # build output, not source
            dirs.remove("_build")
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "quality_record.py")


def test_import_pulls_in_no_jax():
    code = (
        "import pkgutil, importlib, sys, captra_tpu_torch\n"
        "for m in pkgutil.walk_packages(captra_tpu_torch.__path__,\n"
        "                               'captra_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'flax', 'optax',\n"
        "                                    'orbax', 'captra_tpu', 'cv2'))\n"
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


@pytest.mark.parametrize("module", [
    "captra_tpu_torch.cli.train", "captra_tpu_torch.cli.finetune",
    "captra_tpu_torch.training.trainer", "captra_tpu_torch.models.losses",
    "captra_tpu_torch.training.rollout",
    "captra_tpu_torch.cli.rollout_finetune", "captra_tpu_torch.data.blur",
    "captra_tpu_torch.data.sapien", "captra_tpu_torch.training.convert",
    "captra_tpu_torch.parallel.mesh", "captra_tpu_torch.parallel.dryrun",
    "captra_tpu_torch.training.orbax_io", "captra_tpu_torch.eval.visualize",
    "captra_tpu_torch.cli.visualize",
    # the quality harness, in one process
    "captra_tpu_torch.eval.quality, captra_tpu_torch.cli.flagship_demo, "
    "captra_tpu_torch.cli.eval_checkpoint_track, "
    "captra_tpu_torch.cli.gtless_init_probe, "
    "captra_tpu_torch.cli.train_basin_head"])
def test_training_entry_points_import_with_jax_blocked(module):
    """The training, data-parallel, checkpoint and visualiser modules
    import in a process where importing jax, flax, optax, orbax,
    captra_tpu or cv2 fails, and tensorstore and matplotlib too (the
    card's machine has neither: they are imported where they are used)."""
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'flax', 'optax', 'orbax',\n"
        "                                  'captra_tpu', 'cv2',\n"
        "                                  'tensorstore', 'matplotlib'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"import {module}\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_optional_packages_are_imported_inside_functions():
    """tensorstore and matplotlib are imported where a function needs
    them, never at a module's top level."""
    top = re.compile(r"^(?:import|from)\s+(tensorstore|matplotlib)\b", re.M)
    inner = re.compile(r"^\s+(?:import|from)\s+(tensorstore|matplotlib)\b",
                       re.M)
    found = set()
    for path in _sources():
        with open(path) as f:
            text = f.read()
        hit = top.search(text)
        assert hit is None, f"{path} imports {hit.group(1)} at the top"
        found.update(m.group(1) for m in inner.finditer(text))
    assert found == {"tensorstore", "matplotlib"}


def test_forbidden_pattern_catches_imports():
    for line in ("import jax", "from jax import numpy", "import flax.linen",
                 "from captra_tpu.ops import fps", "  import captra_tpu",
                 "import optax", "from orbax import checkpoint as ocp",
                 "import cv2", "from cv2 import imread"):
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
        "init_pose_from_cloud": lambda: init_pose_from_cloud(
            np.zeros((1, 8, 3), np.float32), 1),
        "search_init_orientation": lambda: search_init_orientation(
            None, np.zeros((1, 8, 3), np.float32), Pose.identity((1, 1)),
            cfg),
        "cli.track.main": lambda: track_cli.main(["--synthetic_data"]),
        "cli.track.main on disk": lambda: track_cli.main(
            ["--mode_name", "real_test"]),
        "cli.evaluate.main": lambda: evaluate_cli.main([]),
        "evaluate_results_dir": lambda: evaluate_results_dir(
            "results", cfg.obj),
        "build_step": lambda: track_cli.build_step(cfg, {}, {}),
        "Trainer": lambda: Trainer(cfg.replace(network=dataclasses.replace(
            cfg.network, type="canon_coord"))),
        "cli.train.main": lambda: train_cli.main(["--synthetic_data"]),
        "cli.finetune.main": lambda: finetune_cli.main([]),
        "collect_states": lambda: collect_states(cfg, None, None, {},
                                                 Pose.identity((1, 1))),
        "make_finetune_round": lambda: make_finetune_round(
            cfg, None, None, {}, traj_batch=1, traj_frames=2, minibatch=1),
        "cli.rollout_finetune.main": lambda: rollout_cli.main(
            ["--coord", "c", "--rot", "r", "--out", "o"]),
        "dryrun_multichip": lambda: dryrun_multichip(2),
        "cli.eval_checkpoint_track.main": lambda: eval_ckpt_cli.main(
            ["--coord", "c", "--rot", "r"]),
        "cli.flagship_demo.main": lambda: flagship_cli.main(
            ["--out", "o"]),
        "cli.gtless_init_probe.main": lambda: probe_cli.main(
            ["--coord", "c", "--rot", "r"]),
        "cli.train_basin_head.main": lambda: basin_cli.main(
            ["--coord", "c", "--out", "o"]),
        "parallel.mesh.launch": lambda: mesh.launch(print, 2),
        "cli.sym_pwm_ablation.main": lambda: pwm_cli.main([]),
        "cli.smoke_train_track.main": lambda: smoke_cli.main([]),
        "cli.init_search_scorer_diag.main": lambda: diag_cli.main(
            ["--coord", "c", "--rot", "r"]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points(None)))
def test_entry_points_need_cuda_or_an_explicit_device(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(tiny_config(schema))[name]()


def test_code_built_bottle_config_equals_yaml():
    built = nocs_bottle()
    loaded = get_config("config_track.yml", overrides=NOCS_BOTTLE_OVERRIDES)
    for f in dataclasses.fields(schema.Config):
        assert getattr(built, f.name) == getattr(loaded, f.name), f.name
    assert built == loaded
    assert built.obj.sym and built.obj.num_parts == 1
    assert built.num_points == 4096
    assert built.pointnet == schema.PointNetCfg()
