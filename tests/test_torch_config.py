"""The port's config system: its YAML-subset reader and writer against
PyYAML, and parse_args against the JAX package's."""

import glob
import math
import os

import pytest
import yaml

from mhmocap_tpu import config as JCfg
from mhmocap_tpu_torch import config as TCfg
from mhmocap_tpu_torch import sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_repo_configs_parse_like_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert TCfg.load_yaml(text) == yaml.full_load(text)


def test_sweep_config_round_trips():
    """yaml.safe_dump of the sweep's config reads back as the same dict,
    and the port's writer is read back by both readers."""
    cfg = sweep.sweep_config("/data/mupots synth", 100, bench_cycles=[30, 45],
                             tiny=1e-05, none=None, label="it's: # x")
    assert TCfg.load_yaml(yaml.safe_dump(cfg)) == cfg
    mine = TCfg.dump_yaml(cfg)
    assert yaml.full_load(mine) == cfg
    assert TCfg.load_yaml(mine) == cfg


@pytest.mark.parametrize("tok", ["1e-05", "1.0e-05", "-1.5e+3", ".5", "1.",
                                 "-.5", "0.0001", "-1", "+3", "1_000", "~",
                                 "null", "", "Yes", "OFF", "on", "true",
                                 "False", ".inf", "-.Inf", "'a''b'",
                                 '"a\\tb"', "a#b", "a # comment",
                                 "/x/y z", "[1, 2.5, 'c', [true]]", "[]",
                                 "{}"])
def test_scalars_resolve_like_pyyaml(tok):
    ref = yaml.full_load("k: " + tok)["k"]
    got = TCfg.load_yaml("k: " + tok)["k"]
    assert got == ref and type(got) is type(ref)


@pytest.mark.parametrize("text", ["k: &a 1", "k: !!int 1", "k: |\n  x",
                                  "k: {a: 1}", "- a: 1", "k:\n  a\n  b",
                                  "k: 0x1f", "k: 012", "k: 1:30",
                                  "k:\n- - 1", "a: 1\na: 2"])
def test_unsupported_yaml_raises(text):
    with pytest.raises(ValueError):
        TCfg.load_yaml(text)


def test_nan_scalar():
    assert math.isnan(TCfg.load_yaml("k: .nan")["k"])


@pytest.mark.parametrize("argv", [
    [],
    ["--num_iter", "7", "--resize_factor=0.5"],
    ["--input_path", "/some/where", "--ts_id", "3"],
    ["--batch_size", "2", "--reg_poses_coef", "0.5"],
])
def test_parse_args_precedence_matches(argv):
    """CLI over YAML over argparse defaults, the sub-dicts, and the
    --input_path override of data_path: the port's namespace is the JAX
    package's plus the new --device flag."""
    base = ["--configs_yml", "configs/predict_mupots.yml"] + argv
    ref = vars(JCfg.parse_args(base))
    got = vars(TCfg.parse_args(base))
    assert got.pop("device") == "cuda"
    assert got == ref


def test_device_flag_and_gpu_check():
    import torch
    got = TCfg.parse_args(["--configs_yml", "configs/eval_mupots.yml",
                           "--device", "cpu"])
    assert TCfg.resolve_device(got) == torch.device("cpu")
    if not torch.cuda.is_available():
        got.device = "cuda"
        with pytest.raises(RuntimeError, match="--device cpu"):
            TCfg.resolve_device(got)
