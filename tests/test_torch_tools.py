"""The port's checkpoint tools (``divergen_tpu_torch/tools/``) against the
JAX package's root tools, on the CPU.

- ``convert_imgnet_model_to_lvis.truncate`` against ``truncate_tree`` on one
  flax tree carried over by ``params_from_jax``: the class axis of a flax
  Dense kernel is its last, of the port's weight its first.
- ``import_reference_checkpoint`` on ``synthetic_detector_state_dict`` (a
  tiny Swin detector) against the JAX ``load_d2_detector_into`` of the same
  file, through ``params_from_jax``; the checkpoint it writes restores into
  the template ``do_train`` builds.
- ``build_zs_weights`` against the JAX tool on a 3-category JSON and one
  tiny random CLIP checkpoint that both load (1e-4 of max |reference|).
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.backbone import swin as jswin
from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu.modeling.text import clip as jclip
from divergen_tpu.utils import torch_weights as jtw
from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.engine.checkpoint import Checkpointer
from divergen_tpu_torch.engine.train_loop import TrainState, create_train_state
from divergen_tpu_torch.modeling.backbone import swin as tswin
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from divergen_tpu_torch.modeling.text import clip as tclip
from divergen_tpu_torch.solver.build import build_optimizer
from divergen_tpu_torch.tools import build_zs_weights as tzs
from divergen_tpu_torch.tools import convert_imgnet_model_to_lvis as tconv
from divergen_tpu_torch.tools import import_reference_checkpoint as timport
from divergen_tpu_torch.utils.convert import params_from_jax
from test_torch_detector import assert_rel_close
from test_torch_port_weights import (CLIP_TINY, SWIN_TINY, synthetic_clip_state_dict,
                                     synthetic_detector_state_dict, synthetic_swin_state_dict)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def classifier_tree(rng, n_in, fc=6, zs_dim=8):
    """A flax tree with the leaves the tools must cut and some they must not:
    three linear cascade predictors (kernel (fc, C + 1), bias, a freq-style
    vector of C), a zero-shot one (its ``zs_weight`` (zs_dim, C + 1) is not
    under ``cls_score``), box regressors and a non-predictor leaf."""
    f = lambda *s: rng.randn(*s).astype(np.float32)
    heads = {f"box_predictor{k}": {"cls_score": {"kernel": f(fc, n_in + 1),
                                                 "bias": f(n_in + 1), "freq_weight": f(n_in)},
                                   "bbox_pred": {"kernel": f(fc, 4), "bias": f(4)}}
             for k in range(3)}
    heads["box_predictor3"] = {"cls_score": {"linear": {"kernel": f(fc, zs_dim),
                                                        "bias": f(zs_dim)}},
                               "zs_weight": f(zs_dim, n_in + 1)}
    return {"roi_heads": heads, "fpn": {"out": {"kernel": f(1, 1, 3, n_in + 1)}}}


def test_truncate_matches_jax(tmp_path):
    n_in, n_out = 13, 9
    tree = classifier_tree(np.random.RandomState(0), n_in)
    want = params_from_jax(jax_tool("convert_imgnet_model_to_lvis").truncate_tree(
        tree, n_in, n_out))
    got = tconv.truncate(params_from_jax(tree), n_in, n_out)
    assert sorted(got) == sorted(want)  # jax.tree_util sorts the keys
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert got["roi_heads.box_predictor1.cls_score.weight"].shape == (n_out + 1, 6)
    assert got["roi_heads.box_predictor1.cls_score.freq_weight"].shape == (n_out,)
    assert got["roi_heads.box_predictor3.zs_weight"].shape == (8, n_in + 1)

    # the tool: model and EMA cut, the optimizer state dropped
    state = params_from_jax(tree)
    torch.save({"step": 3, "model": state, "ema_params": dict(state),
                "optimizer": {"optim": {}, "count": 3}},
               Checkpointer(str(tmp_path / "in")).path(3))
    assert tconv.main(["--input_dir", str(tmp_path / "in"), "--output_dir", str(tmp_path / "out"),
                       "--input_num_category", str(n_in),
                       "--output_num_category", str(n_out)]) == 0
    raw = Checkpointer(str(tmp_path / "out")).load()
    assert raw["step"] == 3 and raw["optimizer"] is None
    for part in ("model", "ema_params"):
        for k in want:
            np.testing.assert_array_equal(raw[part][k].numpy(), want[k].numpy(), err_msg=k)


def tiny_cfgs():
    jentry = importlib.import_module("__graft_entry__")
    cfgs = []
    for small in (lambda: jentry._small_cfg(backbone="swin"),
                  lambda: tge._small_cfg(backbone="swin")):
        cfg = small()
        cfg.MODEL.SWIN.SIZE = "tiny"
        cfg.MODEL.FPN.OUT_CHANNELS = 32
        cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
        cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 16
        cfg.INPUT.TRAIN_SIZE = 128  # no stage below the 4-token window: no table shrinks
        cfgs.append(cfg)
    return cfgs


def test_import_reference_checkpoint_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(jswin.SIZE2CONFIG, "tiny", SWIN_TINY)
    monkeypatch.setitem(tswin.SIZE2CONFIG, "tiny", SWIN_TINY)
    rng = np.random.RandomState(12)
    embed, depths, heads, window, _ = SWIN_TINY
    swin = synthetic_swin_state_dict(rng, embed, depths, heads, window,
                                     prefix="backbone.bottom_up.")
    sd = synthetic_detector_state_dict(rng, swin, (32, 64, 128))
    pth = str(tmp_path / "ref.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
    jcfg, tcfg = tiny_cfgs()
    cfg_file = tmp_path / "tiny.yaml"
    cfg_file.write_text(tcfg.dump())

    out = str(tmp_path / "out")
    summary = timport.main(["--config-file", str(cfg_file), "--checkpoint", pth, "--output", out,
                            "--step", "7", "--ema"])
    raw = Checkpointer(out).load(7)
    assert summary["path"] == Checkpointer(out).path(7) and raw["step"] == 7
    assert summary["skipped"] == [] and set(summary["entries"]) - set(summary["loaded"]) == {
        "bottom_up.s2_norm.weight", "bottom_up.s2_norm.bias"}

    jm = jrcnn.build_model(jcfg)
    images, sizes = jnp.zeros((1, 128, 128, 3)), jnp.asarray([[128, 128]], jnp.int32)
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(jax.eval_shape(
        lambda k: jm.init(k, images, sizes, training=False), jax.random.PRNGKey(0))))
    jtree = jtw.load_d2_detector_into(tree, pth, jcfg, fpn_in_features=jm.fpn_in_features,
                                      swin_depths=depths)
    template = trcnn.build_model(tcfg, input_size=(128, 128), device="cpu",
                                 param_dtype=torch.float32)
    want = params_from_jax(jtree, template)
    # every entry the checkpoint fills: all but the stride-4 norm a detectron2 Swin lacks
    unfilled = {"bottom_up.s2_norm.weight", "bottom_up.s2_norm.bias"}
    assert set(raw["model"]) == set(want)
    for k in sorted(set(want) - unfilled):
        np.testing.assert_array_equal(raw["model"][k].numpy(), want[k].numpy(), err_msg=k)
    params = dict(template.named_parameters())
    assert set(raw["ema_params"]) == set(params)
    for k, v in raw["ema_params"].items():
        np.testing.assert_array_equal(v.numpy(), raw["model"][k].numpy(), err_msg=k)

    # the TrainState do_train builds restores it (train_net --resume / --eval-only)
    state = create_train_state(template, build_optimizer(tcfg, template), ema=True)
    restored, start = Checkpointer(out).resume_or_load(state)
    assert isinstance(restored, TrainState) and start == 7 and restored.step == 7
    np.testing.assert_array_equal(
        template.state_dict()["fpn.top_p7.conv.weight"].numpy(),
        sd["backbone.top_block.p7.weight"])


def test_build_zs_weights_matches_jax(tmp_path, monkeypatch):
    tiny = (CLIP_TINY["embed"], CLIP_TINY["vision"], CLIP_TINY["text"])
    monkeypatch.setitem(jclip.CLIP_CONFIGS, "ViT-L/14", tiny)
    monkeypatch.setitem(tclip.CLIP_CONFIGS, "ViT-L/14", tiny)
    sd = synthetic_clip_state_dict(np.random.RandomState(0), **dict(CLIP_TINY, image_size=224))
    ckpt = str(tmp_path / "clip.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    cats = {"categories": [{"id": 3, "name": "zebra", "synonyms": ["zebra"]},
                           {"id": 1, "name": "aerosol_can", "synonyms": ["aerosol_can", "spray"]},
                           {"id": 2, "name": "apple"}]}
    cat_json = tmp_path / "cats.json"
    cat_json.write_text(json.dumps(cats))
    common = ["--cat_json", str(cat_json), "--clip_ckpt", ckpt, "--prompt", "a photo of a {}"]
    assert jax_tool("build_zs_weights").main(common + ["--out", str(tmp_path / "j.npy")]) == 0
    assert tzs.main(common + ["--out", str(tmp_path / "t.npy"), "--device", "cpu"]) == 0
    want, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert got.shape == want.shape == (3, CLIP_TINY["embed"]) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    assert_rel_close(got, want, 1e-4)


@pytest.mark.parametrize("bake", [False, True], ids=["weights_separate", "baked"])
def test_export_model_exports_the_checkpoints_ema_weights(tmp_path, monkeypatch, capsys, bake):
    """``tools.export_model --ema --run-sample`` on the CPU: the sample run of
    the artifact equals the eager forward with the checkpoint's EMA weights;
    with no checkpoint it says so and exports seeded random weights."""
    from divergen_tpu_torch.tools import export_model as texp

    monkeypatch.setitem(tswin.SIZE2CONFIG, "tiny", SWIN_TINY)
    _, cfg = tiny_cfgs()
    cfg_file = tmp_path / "tiny.yaml"
    cfg_file.write_text(cfg.dump())
    model = trcnn.build_model(cfg, input_size=(64, 64), device="cpu", param_dtype=torch.float32)
    tge.fast_init_(model, torch.Generator().manual_seed(1))
    state = create_train_state(model, None, ema=True)
    state.step = 5
    gen = torch.Generator().manual_seed(2)
    for v in state.ema_params.values():
        v.add_(0.05 * torch.randn(v.shape, generator=gen))
    Checkpointer(str(tmp_path / "ck")).save(5, state)
    argv = ["--config-file", str(cfg_file), "--output", str(tmp_path / "m.pt2z"), "--height", "64",
            "--width", "64", "--checkpoint-dir", str(tmp_path / "ck"), "--ema", "--run-sample",
            "--device", "cpu"] + (["--bake-params"] if bake else [])
    got = texp.main(argv)
    assert "loaded step-5 EMA params" in capsys.readouterr().out

    eager = trcnn.build_model(cfg, input_size=(64, 64), device="cpu").eval()
    eager.load_state_dict(state.model.state_dict())
    with torch.no_grad():
        for k, p in eager.named_parameters():
            p.copy_(state.ema_params[k])
        want = eager(torch.zeros(1, 64, 64, 3), torch.tensor([[64, 64]], dtype=torch.int32))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)

    if bake:
        return
    # without a checkpoint: the seeded random weights go to the export. A
    # weights-separate program holds no weights, so the one just traced for
    # this architecture and canvas serves (tracing it again would give the
    # same graph); the artifact is still saved, loaded and its inputs checked
    from divergen_tpu_torch import export as texport

    traced, handed = texport.load_exported(str(tmp_path / "m.pt2z")), {}

    def export_once(model, params, **kw):
        assert not kw["bake_params"] and (kw["height"], kw["width"]) == (64, 64)
        handed.update(params)
        return traced.exported

    monkeypatch.setattr(texport, "export_inference", export_once)
    texp.main(["--config-file", str(cfg_file), "--output", str(tmp_path / "r.pt2z"),
               "--height", "64", "--width", "64", "--checkpoint-dir", str(tmp_path / "none"),
               "--device", "cpu"])
    assert "exporting random init" in capsys.readouterr().out
    seeded = trcnn.build_model(cfg, input_size=(64, 64), device="cpu").eval()
    tge.fast_init_(seeded, torch.Generator().manual_seed(0))
    assert set(handed) == set(seeded.state_dict())
    assert all(torch.equal(handed[k], v) for k, v in seeded.state_dict().items())
    assert texport.load_exported(str(tmp_path / "r.pt2z")).in_avals == traced.in_avals
