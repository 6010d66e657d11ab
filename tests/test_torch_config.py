"""The port's config tree against the JAX package's.

The port keeps its own copy of ``config/config.py`` and ``config/defaults.py``;
here the two trees are held equal, ``flagship_cfg()`` is held against the YAML
files it stands for, and ``get_cfg()`` / ``merge_from_list`` are shown to work
on a machine without PyYAML.
"""
import builtins
import os
import sys

import pytest

from divergen_tpu.config import get_cfg as jget
from divergen_tpu_torch import graft_entry
from divergen_tpu_torch.config import ConfigNode, get_cfg

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
YAMLS = sorted(f for f in os.listdir(CONFIGS) if f.endswith(".yaml"))

# what the model and the test path read of the flagship config: the subtrees
# build_model and the from_cfg constructors name, and the sizes and dtype
MODEL_AND_TEST_KEYS = ["MODEL", "TEST", "FP16", "WITH_IMAGE_LABELS", "INPUT.TEST_SIZE",
                       "INPUT.TRAIN_SIZE", "INPUT.FORMAT"]


def get_path(cfg, path):
    for part in path.split("."):
        cfg = cfg[part]
    return cfg


def plain(value):
    """Tuples and lists compare alike (a YAML list is a tuple in the defaults)."""
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    return value


def test_defaults_dump_equal():
    assert get_cfg().dump() == jget().dump()
    assert get_cfg().to_dict() == jget().to_dict()


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_files_merge_alike(name):
    ours, theirs = get_cfg(), jget()
    ours.merge_from_file(os.path.join(CONFIGS, name))
    theirs.merge_from_file(os.path.join(CONFIGS, name))
    assert ours.dump() == theirs.dump()


def test_merge_from_list_alike():
    opts = ["MODEL.SWIN.SIZE", "L-22k-384", "FP16", "true", "MODEL.ROI_HEADS.NUM_CLASSES", "1453",
            "MODEL.ROI_BOX_CASCADE_HEAD.IOUS", "[0.6, 0.7, 0.8]", "SOLVER.BASE_LR", "1",
            "MODEL.WEIGHTS", "models/x.pkl", "MODEL.CENTERNET.SOI", "[[0, 80], [64, 10000000]]"]
    ours, theirs = get_cfg(), jget()
    ours.merge_from_list(opts)
    theirs.merge_from_list(opts)
    assert ours.dump() == theirs.dump()
    assert ours.MODEL.ROI_BOX_CASCADE_HEAD.IOUS == (0.6, 0.7, 0.8) and ours.SOLVER.BASE_LR == 1.0


def test_freeze_clone_and_unknown_keys():
    cfg = get_cfg().freeze()
    with pytest.raises(AttributeError, match="frozen"):
        cfg.MODEL.SWIN.SIZE = "B"
    thawed = cfg.clone()
    thawed.MODEL.SWIN.SIZE = "B"
    assert cfg.MODEL.SWIN.SIZE == "T" and isinstance(thawed.MODEL, ConfigNode)
    with pytest.raises(KeyError, match="Unknown config key"):
        get_cfg()._merge_dict({"NOT_A_KEY": 1})


@pytest.mark.parametrize("key", MODEL_AND_TEST_KEYS)
def test_flagship_cfg_equals_the_yaml(key):
    want = jget()
    want.merge_from_file(os.path.join(CONFIGS, "DiverGen_swinL.yaml"))
    assert plain(get_path(graft_entry.flagship_cfg(), key)) == plain(get_path(want, key))


def test_flagship_cfg_is_the_flagship_model():
    cfg = graft_entry.flagship_cfg()
    assert cfg.MODEL.SWIN.SIZE == "L-22k-384" and cfg.MODEL.ROI_HEADS.NUM_CLASSES == 1453
    assert cfg.FP16 is True and cfg.INPUT.TEST_SIZE == 896
    assert cfg.MODEL.ROI_BOX_CASCADE_HEAD.IOUS == (0.6, 0.7, 0.8)
    assert cfg.TEST.DETECTIONS_PER_IMAGE == 300 and cfg.MODEL.CENTERNET.POST_NMS_TOPK_TEST == 256


def test_small_cfg_equals_the_jax_entry():
    import importlib

    jentry = importlib.import_module("__graft_entry__")
    assert graft_entry._small_cfg().dump() == jentry._small_cfg(backbone="swin").dump()
    assert (graft_entry._small_cfg(5, "B").dump()
            == jentry._small_cfg(5, backbone="swin", swin_size="B").dump())


def test_get_cfg_works_without_yaml(monkeypatch):
    """With ``yaml`` un-importable: the defaults, ``merge_from_list`` and the
    two configs of ``graft_entry`` still work; reading a file says why not."""
    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError("No module named 'yaml'")
        return real_import(name, *args, **kwargs)

    with_yaml = graft_entry.flagship_cfg().to_dict()
    monkeypatch.delitem(sys.modules, "yaml", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_yaml)
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.SWIN.SIZE", "L-22k-384", "FP16", "true", "TEST.NMS_CANDIDATES",
                         "2000", "MODEL.PIXEL_STD", "[1.0, 2.0, 3.0]", "SOLVER.BASE_LR", "1",
                         "MODEL.WEIGHTS", "models/x.pkl", "MODEL.FPN.NORM", ""])
    assert cfg.MODEL.SWIN.SIZE == "L-22k-384" and cfg.FP16 is True
    assert cfg.TEST.NMS_CANDIDATES == 2000 and cfg.MODEL.PIXEL_STD == [1.0, 2.0, 3.0]
    assert cfg.SOLVER.BASE_LR == 1.0 and cfg.MODEL.WEIGHTS == "models/x.pkl"
    assert graft_entry.flagship_cfg().to_dict() == with_yaml
    assert graft_entry._small_cfg().MODEL.ROI_HEADS.NUM_CLASSES == 8
    with pytest.raises(ImportError):
        cfg.merge_from_file(os.path.join(CONFIGS, "DiverGen_swinL.yaml"))
    with pytest.raises(ImportError):
        cfg.dump()
