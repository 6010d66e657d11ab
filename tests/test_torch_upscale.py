"""The port's x4 upscaler (stage III) and its parts against the JAX package.

``upscaler_unet(tiny=True)`` (``UNetSDXL`` with ``num_class_embeds``, called
with ``class_labels``), ``VAEEncoder`` (its mode) and the three-level VAE
decoder (×4) run on the same numpy inputs with the same weights (flax
``init`` → ``params_from_jax``), float32 on the CPU, within 1e-4 of max
|ref|. ``UpscalePipeline``'s Euler denoise loop and decode from the same
latents, low-res image and contexts must give images within 0.255 of the
0–255 range of the JAX ``_denoise`` + decode. The upscaler's conditioning,
``SDXLTextEncoder.encode_sliced`` and ``UpscalerTextEncoder``, is held
against the JAX encoders on tiny towers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.pipeline.generation import text as jtext
from divergen_tpu.pipeline.generation import upscale as jup
from divergen_tpu.pipeline.generation import vae as jvae
from divergen_tpu_torch.pipeline.generation import text as ttext
from divergen_tpu_torch.pipeline.generation import upscale as tup
from divergen_tpu_torch.pipeline.generation import vae as tvae
from divergen_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)


def port(module, tree):
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
    return module.eval()


def close(got, want, bound=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=bound * np.abs(want).max())


@pytest.fixture(scope="module")
def tiny_upscaler():
    ju = jup.upscaler_unet(tiny=True)
    up = jax.jit(lambda: ju.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 7)), jnp.zeros((1,)),
                                 jnp.zeros((1, 77, 32)),
                                 class_labels=jnp.zeros((1,), jnp.int32)))()
    jv = jvae.VAEDecoder(channels=(8, 8, 8))
    vp = jax.jit(lambda: jv.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 4))))()
    tu = port(tup.upscaler_unet(tiny=True), up)
    tv = port(tvae.VAEDecoder(channels=(8, 8, 8)), vp)
    return (ju, up, jv, vp), (tu, tv)


def test_upscaler_unet_with_class_labels(tiny_upscaler):
    (ju, up, _, _), (tu, _) = tiny_upscaler
    assert tu.class_embed.weight.shape == (1000, 64)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 7).astype(np.float32)
    t = np.array([999.0, 250.5], np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    labels = np.array([100, 7])
    want = ju.apply(up, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                    class_labels=jnp.asarray(labels))
    got = tu(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
             class_labels=torch.from_numpy(labels))
    close(got, want)
    # the label moves the output: the embedding is really added
    other = tu(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
               class_labels=torch.from_numpy(labels[::-1].copy()))
    assert not torch.allclose(other, got)


def test_vae_encoder_mode_and_sample():
    jm = jvae.VAEEncoder(channels=(8, 16))
    x = np.random.RandomState(1).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = port(tvae.VAEEncoder(channels=(8, 16)), p)
    mode = tm(torch.from_numpy(x))
    assert mode.shape == (2, 8, 8, 4)
    close(mode, jm.apply(p, jnp.asarray(x)))
    draw = lambda seed: tm(torch.from_numpy(x), torch.Generator().manual_seed(seed))
    a = draw(0)
    assert torch.equal(a, draw(0)) and not torch.equal(a, draw(1))
    assert torch.isfinite(a).all() and not torch.allclose(a, mode)


def test_x4_vae_decodes_four_times(tiny_upscaler):
    (_, _, jv, vp), (_, tv) = tiny_upscaler
    lat = np.random.RandomState(2).randn(1, 6, 5, 4).astype(np.float32)
    got = tv(torch.from_numpy(lat))
    assert got.shape == (1, 24, 20, 3)
    close(got, jv.apply(vp, jnp.asarray(lat)))


def test_upscale_pipeline_denoise_and_decode(tiny_upscaler):
    (ju, up, jv, vp), (tu, tv) = tiny_upscaler
    rng = np.random.RandomState(3)
    b, steps = 2, 3
    low = rng.uniform(-1, 1, (b, 8, 8, 3)).astype(np.float32)
    lat = rng.randn(b, 8, 8, 4).astype(np.float32)
    ctx, unc = (rng.randn(b, 77, 32).astype(np.float32) for _ in range(2))
    jp = jup.UpscalePipeline(ju, up, jv, vp, steps=steps)
    tp = tup.UpscalePipeline(tu, tv, steps=steps)
    assert tp._init_scale == pytest.approx(float(jp._sigmas[0]), rel=1e-6)
    want_lat = jp._denoise(up, jnp.asarray(lat * tp._init_scale), jnp.asarray(low),
                           jnp.asarray(ctx), jnp.asarray(unc))
    got_lat = tp.denoise(torch.from_numpy(lat * tp._init_scale), torch.from_numpy(low),
                         torch.from_numpy(ctx), torch.from_numpy(unc))
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want_lat)).max())
    want = np.asarray(jnp.clip((jv.apply(vp, want_lat) + 1.0) * 127.5, 0, 255))
    got = tp.decode(got_lat)
    assert got.shape == (b, 32, 32, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-3 * 255


def test_upscale_noises_the_low_res_image(tiny_upscaler):
    """``upscale`` feeds the low-res image noised at the noise level by the
    low-res DDPM schedule, and draws from the generator only."""
    _, (tu, tv) = tiny_upscaler
    tp = tup.UpscalePipeline(tu, tv, steps=2)
    assert tp.noise_level == 100
    np.testing.assert_allclose(tp.low_res_sched.alphas_cumprod,
                               jup.UpscalePipeline(None, None).low_res_sched.alphas_cumprod)
    imgs = torch.rand(1, 8, 8, 3) * 255
    ctx = torch.randn(1, 77, 32)
    run = lambda: tp.upscale(torch.Generator().manual_seed(0), imgs, ctx, torch.zeros_like(ctx))
    a = run()
    assert a.shape == (1, 32, 32, 3) and torch.equal(a, run())
    assert 0 <= a.min() and a.max() <= 255


@pytest.fixture(scope="module")
def tiny_towers():
    enc = jtext.SDXLTextEncoder.random(seed=0, tiny=True)
    clip_l, big_g = ttext.tiny_sdxl_text_towers()
    port(clip_l, enc.params_l)
    port(big_g, enc.params_g)
    return enc, ttext.SDXLTextEncoder(clip_l, big_g)


@pytest.mark.parametrize("width", [32, 80])
def test_encode_sliced(tiny_towers, width):
    jenc, tenc = tiny_towers
    prompts = ["a photo of a single red apple", ""]
    want = np.asarray(jenc.encode_sliced(prompts, width))
    got = tenc.encode_sliced(prompts, width)
    assert got.shape == (2, 77, width)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_upscaler_text_encoder(tiny_towers):
    jenc, _ = tiny_towers
    params = jax.tree.map(np.asarray, jenc.params_g)  # a tree of converted-checkpoint form
    want = np.asarray(jtext.UpscalerTextEncoder(params).encode(["a wooden chair", ""]))
    tower = ttext.tower_from_params(params)
    assert (tower.layers, tower.token_embedding.weight.shape) == (2, (49408, 40))
    got = ttext.UpscalerTextEncoder(tower).encode(["a wooden chair", ""])
    assert got.shape == (2, 77, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("b,n,c,heads,bh,s", [(4, 16384, 512, 8, 2, 65536),
                                              (8, 262144, 512, 8, 4, 1048576)])
def test_attention_plans_at_the_upscaler_lengths(b, n, c, heads, bh, s):
    """``--stages XL x4`` at 256² and at the default 1024²: kernel 1's and
    kernel 3's work items cover every q row once and stay far inside the
    kernels' 32-bit counts."""
    from divergen_tpu_torch.ops import flash_attention as fa

    packed, bhsd = fa.packed_plan(b, n, c, heads), fa.bhsd_plan(bh, s, 512)
    assert packed.items == (-(-n // fa.SM90_TILE), heads, b)
    assert bhsd.items == (s // fa.D512_TILE, 1, bh)
    for plan, rows in ((packed, n), (bhsd, s)):
        assert plan.items[0] * plan.rows >= rows > (plan.items[0] - 1) * plan.rows
        assert np.prod(plan.items) < 2**31 and rows < 2**31
