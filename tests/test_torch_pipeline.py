"""The port's SDXL pipeline and txt2img CLI against the JAX package.

The tiny pipeline's denoise loop runs for both samplers, with and without
Faster-Diffusion encoder reuse, from the same numpy initial latents and
contexts, with the same weights (flax ``init`` → ``params_from_jax``),
float32 on the CPU, then the VAE decode; the images must agree within 1e-3 of
the 0–255 range (0.255). The CLI tests run the port's ``txt2img.main --tiny``
(SDXL at 64², with ``--encoder_reuse`` and with ``--stages XL x4``; the IF
cascade with ``--stages I`` and ``I II``): reference file naming under
``samples/<stage>``, resume, and the stdlib PNG writer read back by OpenCV.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.pipeline.generation import pipeline as jpipe
from divergen_tpu.pipeline.generation import unet as junet
from divergen_tpu.pipeline.generation import vae as jvae
from divergen_tpu_torch.pipeline.generation import pipeline as tpipe
from divergen_tpu_torch.pipeline.generation import txt2img
from divergen_tpu_torch.pipeline.generation import unet as tunet
from divergen_tpu_torch.pipeline.generation import vae as tvae
from divergen_tpu_torch.utils.convert import params_from_jax
from divergen_tpu_torch.utils.png import write_png

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_models():
    lat = jnp.zeros((1, 8, 8, 4))
    ju, jv = junet.UNetSDXL.tiny(), jvae.VAEDecoder(channels=(32, 32))
    up = jax.jit(ju.init)(jax.random.PRNGKey(0), lat, jnp.zeros((1,)), jnp.zeros((1, 77, 64)))
    vp = jax.jit(jv.init)(jax.random.PRNGKey(1), lat)
    tu, tv = tunet.UNetSDXL.tiny(), tvae.VAEDecoder(channels=(32, 32))
    tu.load_state_dict(params_from_jax(jax.tree.map(np.asarray, up)))
    tv.load_state_dict(params_from_jax(jax.tree.map(np.asarray, vp)))
    return (ju, up, jv, vp), (tu, tv)


@pytest.mark.parametrize("encoder_reuse", [False, True])
@pytest.mark.parametrize("sampler", ["euler", "dpmpp_2m"])
def test_tiny_pipeline_denoise_and_decode(tiny_models, sampler, encoder_reuse):
    (ju, up, jv, vp), (tu, tv) = tiny_models
    rng = np.random.RandomState(3)
    b, steps = 2, 3
    lat = rng.randn(b, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(b, 77, 64).astype(np.float32)
    unc = rng.randn(b, 77, 64).astype(np.float32)

    jp = jpipe.SDXLPipeline(ju, up, jv, vp, steps=steps, sampler=sampler,
                            encoder_reuse=encoder_reuse)
    want_lat = jp._denoise(up, jnp.asarray(lat * jp._init_scale), jnp.asarray(ctx),
                           jnp.asarray(unc), None, None, None)
    want = np.stack([np.asarray(jnp.clip((jv.apply(vp, l[None])[0] + 1.0) * 127.5, 0, 255))
                     for l in want_lat])

    tp = tpipe.SDXLPipeline(tu, tv, steps=steps, sampler=sampler, encoder_reuse=encoder_reuse)
    assert tp._init_scale == pytest.approx(jp._init_scale, rel=1e-6)
    got_lat = tp.denoise(torch.from_numpy(lat * tp._init_scale), torch.from_numpy(ctx),
                         torch.from_numpy(unc))
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want_lat)).max())
    got = tp.decode(got_lat)
    assert got.shape == (b, 16, 16, 3)  # the tiny VAE upsamples x2
    assert np.abs(got.numpy() - want).max() <= 1e-3 * 255
    u8 = tpipe.images_to_uint8(got)
    assert u8.dtype == np.uint8 and u8.shape == (b, 16, 16, 3)


def test_tiny_pipeline_over_a_mesh(tiny_models):
    """``SDXLPipeline(mesh=[cpu, cpu])`` against the JAX pipeline over a
    two-device ``"data"`` mesh (the batch sharded, the whole batch decoded at
    once) on the same noise: images within 1e-3 of 255. Each row block equals
    a one-device run of its rows bit for bit (the same shapes and ops). A
    mesh entry the modules cannot run on raises."""
    from jax.sharding import Mesh

    (ju, up, jv, vp), (tu, tv) = tiny_models
    rng = np.random.RandomState(8)
    b, steps = 2, 2
    lat = rng.randn(b, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(b, 77, 64).astype(np.float32)
    unc = rng.randn(b, 77, 64).astype(np.float32)
    jp = jpipe.SDXLPipeline(ju, up, jv, vp, steps=steps, sampler="dpmpp_2m",
                            mesh=Mesh(np.array(jax.devices("cpu")[:2]), ("data",)))
    put = lambda x: jax.device_put(jnp.asarray(x), jp._batch_sharding)
    want_lat = jp._denoise(jp.unet_params, put(lat * jp._init_scale), put(ctx), put(unc), None,
                           None, None)
    want = np.asarray(jnp.clip((jv.apply(jp.vae_params, want_lat) + 1.0) * 127.5, 0, 255))

    tp = tpipe.SDXLPipeline(tu, tv, steps=steps, sampler="dpmpp_2m", mesh=["cpu", "cpu"])
    assert tp.mesh == [torch.device("cpu")] * 2 and tp._replicas[torch.device("cpu")][0] is tu
    x, c, u = (torch.from_numpy(v) for v in (lat * tp._init_scale, ctx, unc))
    got = tp._generate_mesh(x, c, u, None, None, None, decode=True)
    assert got.shape == (b, 16, 16, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-3 * 255
    one = tpipe.SDXLPipeline(tu, tv, steps=steps, sampler="dpmpp_2m")
    for i in range(b):
        rows = one.denoise(x[i:i + 1], c[i:i + 1], u[i:i + 1])
        assert torch.equal(got[i:i + 1], one.decode(rows)), i
    with pytest.raises(ValueError, match="does not split"):
        tp._generate_mesh(x[:1], c[:1], u[:1], None, None, None, decode=False)
    meta = tunet.UNetSDXL.tiny(device="meta")
    with pytest.raises(ValueError, match="mesh entry cpu"):
        tpipe.SDXLPipeline(meta, None, steps=steps, mesh=["cpu"])


def test_txt2img_tiny_naming_resume_png(tmp_path):
    prompts = tmp_path / "prompts"
    prompts.mkdir()
    (prompts / "37.txt").write_text("a photo of a single cat\n")
    out = tmp_path / "out"
    argv = ["--from_file", str(prompts), "--outdir", str(out), "--n_samples", "2",
            "--max_batch_size", "2", "--offset", "5", "--tiny", "--height", "64",
            "--width", "64", "--steps", "2", "--sampler", "dpmpp_2m", "--device", "cpu"]
    assert txt2img.main(argv) == 0
    sample_dir = out / "samples" / "XL"
    names = sorted(os.listdir(sample_dir))
    assert names == ["37_0000005.png", "37_0000006.png"]
    mtimes = [os.stat(sample_dir / n).st_mtime_ns for n in names]
    for n in names:
        img = cv2.imread(str(sample_dir / n), cv2.IMREAD_UNCHANGED)
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert txt2img.main(argv + ["--disable_overwrite"]) == 0
    assert [os.stat(sample_dir / n).st_mtime_ns for n in names] == mtimes


def test_png_writer_round_trips_through_cv2(tmp_path):
    rgb = np.random.RandomState(4).randint(0, 256, (7, 13, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), rgb)
    # OpenCV decodes to BGR: the same pixels cv2.imwrite stores from RGB→BGR
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png"))[..., ::-1], rgb)
    cv2.imwrite(str(tmp_path / "b.png"), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "b.png")),
                                  cv2.imread(str(tmp_path / "a.png")))


def test_unported_flags_exit(tmp_path):
    """Every flag of the JAX CLI is ported: --data_parallel splits a batch over
    the local cards where there are several, so on the CPU (as on one card)
    it writes the images of a run without it, bit for bit."""
    argv = ["--tiny", "--height", "64", "--width", "64", "--steps", "2", "--n_samples", "2",
            "--device", "cpu", "--outdir"]
    assert txt2img.main(argv + [str(tmp_path / "a")]) == 0
    assert txt2img.main(argv + [str(tmp_path / "b"), "--data_parallel"]) == 0
    names = sorted(os.listdir(tmp_path / "a" / "samples" / "XL"))
    assert len(names) == 2 and names == sorted(os.listdir(tmp_path / "b" / "samples" / "XL"))
    for n in names:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a" / "samples" / "XL" / n)),
                                      cv2.imread(str(tmp_path / "b" / "samples" / "XL" / n)))


@pytest.mark.parametrize("stages", [["II"], ["XL", "II"], ["x4", "I"]])
def test_if_stages_must_start_with_stage_one(stages, tmp_path):
    """As in JAX: an IF stage list not led by I exits before any model is
    built, and writes nothing."""
    with pytest.raises(SystemExit, match="must start with 'I'"):
        txt2img.main(["--stages", *stages, "--tiny", "--device", "cpu", "--outdir",
                      str(tmp_path)])
    assert not os.listdir(tmp_path)


def run_cli(tmp_path, *extra):
    """``txt2img.main --tiny`` over one category file with two samples at
    offset 5, twice: then again with --disable_overwrite, which must leave
    every file as it was. Returns {stage dir: sorted names}."""
    prompts = tmp_path / "prompts"
    prompts.mkdir(exist_ok=True)
    (prompts / "37.txt").write_text("a photo of a single cat\n")
    out = tmp_path / "out"
    argv = ["--from_file", str(prompts), "--outdir", str(out), "--n_samples", "2",
            "--max_batch_size", "2", "--offset", "5", "--tiny", "--height", "64", "--width",
            "64", "--steps", "2", "--device", "cpu", *extra]
    assert txt2img.main(argv) == 0
    samples = out / "samples"
    files = {d: sorted(os.listdir(samples / d)) for d in sorted(os.listdir(samples))}
    mtimes = {(d, n): os.stat(samples / d / n).st_mtime_ns for d, ns in files.items() for n in ns}
    assert txt2img.main(argv + ["--disable_overwrite"]) == 0
    assert {(d, n): os.stat(samples / d / n).st_mtime_ns for d, n in mtimes} == mtimes
    return samples, files


NAMES = ["37_0000005.png", "37_0000006.png"]


@pytest.mark.parametrize("extra,shapes", [
    (["--encoder_reuse"], {"XL": (16, 16, 3)}),
    (["--encoder_reuse", "--sampler", "dpmpp_2m"], {"XL": (16, 16, 3)}),
    # the tiny x4 VAE decodes the 16² SDXL image's latent grid x4
    (["--stages", "XL", "x4"], {"XL": (16, 16, 3), "x4": (64, 64, 3)}),
    (["--stages", "I"], {"I": (16, 16, 3)}),
    (["--stages", "I", "II"], {"I": (16, 16, 3), "II": (32, 32, 3)}),
])
def test_txt2img_tiny_stages(tmp_path, extra, shapes):
    samples, files = run_cli(tmp_path, *extra)
    assert files == {d: NAMES for d in shapes}
    for d, shape in shapes.items():
        for n in NAMES:
            img = cv2.imread(str(samples / d / n), cv2.IMREAD_UNCHANGED)
            assert img.shape == shape and img.dtype == np.uint8


def test_t5_dir_without_transformers_says_so(tmp_path, monkeypatch):
    """``--t5_dir`` runs T5 through the host's ``transformers``; where it is
    missing the CLI exits naming it, and never falls back to random states."""
    import builtins

    real_import = builtins.__import__

    def no_transformers(name, *a, **kw):
        if name == "transformers" or name.startswith("transformers."):
            raise ImportError("No module named 'transformers'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(SystemExit, match="transformers"):
        txt2img.main(["--stages", "I", "--tiny", "--device", "cpu", "--t5_dir", str(tmp_path),
                      "--outdir", str(tmp_path / "out"), "--steps", "2"])


def _no_device_entry_points():
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.pipeline.filteration import cli as fcli
    from divergen_tpu_torch.pipeline.filteration.core import ClipEncoder
    from divergen_tpu_torch.pipeline.segmentation import corner_masks

    return {
        "txt2img": lambda d: txt2img.main(["--tiny", "--prompt", "x", "--outdir", d]),
        "txt2img_int8": lambda d: txt2img.main(["--tiny", "--int8", "--prompt", "x", "--outdir", d]),
        "txt2img_if": lambda d: txt2img.main(["--tiny", "--stages", "I", "II", "--prompt", "x",
                                              "--outdir", d]),
        "txt2img_x4": lambda d: txt2img.main(["--tiny", "--stages", "XL", "x4", "--prompt", "x",
                                              "--outdir", d]),
        "txt2img_reuse": lambda d: txt2img.main(["--tiny", "--encoder_reuse", "--prompt", "x",
                                                 "--outdir", d]),
        "corner_masks": lambda d: corner_masks.main(["--tiny", "--in_dir", d, "--out_dir", d]),
        "build_sam": lambda d: corner_masks.build_sam(
            corner_masks.build_argparser().parse_args(["--tiny", "--in_dir", d, "--out_dir", d])),
        "ClipEncoder": lambda d: ClipEncoder("ViT-B/32", batch=1, image_size=32),
        "extract_features": lambda d: fcli.extract_features(
            ["--in_dir", d, "--out_dir", d, "--model_name", "ViT-B/32"]),
        "train_entry": lambda d: graft_entry.train_entry(),
        "dryrun_train": lambda d: graft_entry.dryrun_train(),
    }


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
@pytest.mark.parametrize("name", ["txt2img", "txt2img_int8", "txt2img_if", "txt2img_x4",
                                  "txt2img_reuse", "corner_masks", "build_sam", "ClipEncoder",
                                  "extract_features", "train_entry", "dryrun_train"])
def test_entry_points_do_not_fall_back_to_the_cpu(name, tmp_path):
    """An entry point that was not asked for the CPU raises when no card is
    visible; none carries on on the CPU on its own."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _no_device_entry_points()[name](str(tmp_path))
