"""The port's SDXL modules against the JAX modules, same weights and inputs.

flax ``init`` makes the weights, ``params_from_jax`` carries them into the
port, numpy makes the inputs; both run in float32 on the CPU. Tolerance:
max |Δ| ≤ 1e-4 · max |reference|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.pipeline.generation import text as jtext
from divergen_tpu.pipeline.generation import unet as junet
from divergen_tpu.pipeline.generation import vae as jvae
from divergen_tpu_torch.pipeline.generation import text as ttext
from divergen_tpu_torch.pipeline.generation import unet as tunet
from divergen_tpu_torch.pipeline.generation import vae as tvae
from divergen_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
TOL = 1e-4


def assert_rel_close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def load(module, params):
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return module.eval()


@pytest.mark.parametrize("text_time", [False, True])
def test_unet_tiny(text_time):
    rng = np.random.RandomState(0)
    b = 2
    lat = rng.randn(b, 16, 16, 4).astype(np.float32)
    t = np.array([999.0, 10.0], np.float32)
    ctx = rng.randn(b, 77, 64).astype(np.float32)
    extra = ((rng.randn(b, 1280).astype(np.float32),
              np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (b, 1)))
             if text_time else ())
    jm = junet.UNetSDXL.tiny(ln_gemm="geglu")
    jargs = [jnp.asarray(a) for a in (lat, t, ctx, *extra)]
    params = jm.init(jax.random.PRNGKey(0), *jargs)
    want = jm.apply(params, *jargs)
    tm = load(tunet.UNetSDXL.tiny(text_time=text_time), params)
    with torch.inference_mode():
        got = tm(*(torch.from_numpy(a) for a in (lat, t, ctx, *extra)))
    assert_rel_close(got.numpy(), want)


def test_unet_plain_geglu_matches_fused():
    """ln_gemm=False (LayerNorm, Dense, split, GELU) equals the fused path."""
    fused = tunet.UNetSDXL.tiny()
    plain = tunet.UNetSDXL.tiny(ln_gemm=False)
    from divergen_tpu_torch.modeling.layers import flax_init_

    flax_init_(fused, torch.Generator().manual_seed(0))
    plain.load_state_dict(fused.state_dict())
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(1, 16, 16, 4, generator=g), torch.tensor([500.0]),
            torch.randn(1, 77, 64, generator=g))
    with torch.inference_mode():
        assert_rel_close(plain(*args).numpy(), fused(*args).numpy(), tol=1e-5)


def test_vae_decoder():
    # 12x12 latents: 144 tokens > 128, so the mid attention takes the
    # flash_attention branch of _attention
    z = np.random.RandomState(1).randn(1, 12, 12, 4).astype(np.float32)
    jm = jvae.VAEDecoder(channels=(32, 32))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(z))
    want = jm.apply(params, jnp.asarray(z))
    tm = load(tvae.VAEDecoder(channels=(32, 32)), params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(z))
    assert got.shape == (1, 24, 24, 3)
    assert_rel_close(got.numpy(), want)


def test_text_encoder_tiny():
    jenc = jtext.SDXLTextEncoder.random(seed=0, tiny=True)
    clip_l, big_g = ttext.tiny_sdxl_text_towers()
    tenc = ttext.SDXLTextEncoder(load(clip_l, jenc.params_l), load(big_g, jenc.params_g))
    prompts = ["a photo of a single red apple", ""]
    for a, b in zip(jenc.tokenize(prompts), tenc.tokenize(prompts)):
        np.testing.assert_array_equal(a, b)
    want_ctx, want_pooled = jenc.encode(prompts)
    ctx, pooled = tenc.encode(prompts)
    assert ctx.shape == (2, 77, 64) and pooled.shape == (2, 40)
    assert_rel_close(ctx.numpy(), want_ctx)
    assert_rel_close(pooled.numpy(), want_pooled)


def test_constructor_rejects_unported_options():
    for kw in ({"ln_gemm": "all"}, {"conv_matmul": "im2col"}):
        with pytest.raises((NotImplementedError, ValueError)):
            tunet.UNetSDXL.tiny(**kw)
    # num_class_embeds is ported: the x4 upscaler's noise-level embedding
    assert tunet.UNetSDXL.tiny(num_class_embeds=1000).class_embed.num_embeddings == 1000


def test_flax_init_scales_like_flax():
    """lecun-normal kernels (truncated at 2σ, variance 1/fan_in), zero biases,
    unit norm scales, normal(0.01) positional embedding: the same statistics
    as the JAX package's flax initializers."""
    from divergen_tpu_torch.modeling.layers import Conv, Dense, flax_init_
    from divergen_tpu_torch.modeling.text.clip import CLIPText

    gen = torch.Generator().manual_seed(0)
    lin, conv = flax_init_(Dense(400, 300), gen), flax_init_(Conv(16, 64, 3), gen)
    want = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (400, 300)))
    for w, fan_in in ((lin.weight, 400), (conv.weight, 16 * 9)):
        std = fan_in ** -0.5
        assert abs(w.std().item() - std) < 0.03 * std
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(lin.weight.std().item() - want.std()) < 0.03 * want.std()
    assert not lin.bias.any() and not conv.bias.any()
    text = flax_init_(CLIPText(embed_dim=8, width=16, heads=2, layers=1, vocab_size=100), gen)
    assert torch.all(text.ln_final.weight == 1) and not text.ln_final.bias.any()
    assert abs(text.positional_embedding.std().item() - 0.01) < 0.002
