"""The port's DeepFloyd-IF cascade against the JAX package.

Each module of ``pipeline/generation/if_unet.py`` (``AttentionPooling``,
``TextTimeEmbedding``, ``IFResBlock`` plain / down / up, ``AddedKVAttention``)
and the tiny stage-I and stage-II ``IFUNet`` of ``txt2img --tiny`` run on the
same numpy inputs with the same weights (flax ``init`` → ``params_from_jax``),
float32 on the CPU, within 1e-4 of max |ref|. Three stage-I and stage-II
steps with the same per-step numpy noise (through ``step_noise``) are held
against a loop of the JAX pipeline's ``_cfg_eps`` and
``ddpm_learned_range_step`` within 1e-4 of the [-1, 1] range; stage II's
bilinear x4 against ``jax.image.resize``, edges included; the release
sizings' parameter counts against the JAX ``eval_shape``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.pipeline.generation import if_unet as jif
from divergen_tpu.pipeline.generation import scheduler as jsched
from divergen_tpu_torch.pipeline.generation import if_unet as tif
from divergen_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

# txt2img --tiny's stage-I UNet
TINY = dict(channels=(8, 16), layers_per_block=1, encoder_dim=16, head_dim=4, pool_heads=2)


def port(module, tree):
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
    return module.eval()


def close(got, want, bound=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=bound * np.abs(want).max())


def randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def test_attention_pooling_and_text_time_embedding():
    rng = np.random.RandomState(0)
    x = randn(rng, 2, 7, 16)
    jm = jif.AttentionPooling(num_heads=2)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    close(port(tif.AttentionPooling(16, 2), p)(torch.from_numpy(x)), jm.apply(p, jnp.asarray(x)))
    jm = jif.TextTimeEmbedding(time_embed_dim=32, num_heads=2)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # LayerNorm scales and biases away from 1 and 0
    p = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(2), a.shape), p)
    close(port(tif.TextTimeEmbedding(16, 32, 2), p)(torch.from_numpy(x)),
          jm.apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("cin,cout,mode", [(8, 8, "plain"), (8, 16, "plain"), (16, 16, "down"),
                                           (16, 16, "up")])
def test_if_resblock(cin, cout, mode):
    rng = np.random.RandomState(1)
    x, temb = randn(rng, 2, 8, 8, cin), randn(rng, 2, 32)
    kw = {"down": mode == "down", "up": mode == "up"}
    jm = jif.IFResBlock(cout, **kw)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(temb))
    p = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(3), a.shape), p)
    got = port(tif.IFResBlock(cin, cout, 32, **kw), p)(torch.from_numpy(x), torch.from_numpy(temb))
    close(got, jm.apply(p, jnp.asarray(x), jnp.asarray(temb)))


def test_added_kv_attention():
    rng = np.random.RandomState(2)
    x, ctx = randn(rng, 2, 4, 4, 16), randn(rng, 2, 5, 12)
    jm = jif.AddedKVAttention(head_dim=4)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx))
    got = port(tif.AddedKVAttention(16, 12, 4), p)(torch.from_numpy(x), torch.from_numpy(ctx))
    close(got, jm.apply(p, jnp.asarray(x), jnp.asarray(ctx)))


@pytest.fixture(scope="module")
def tiny_unets():
    """txt2img --tiny's two UNets, JAX and port, on the same weights."""
    out = {}
    for stage, cin, kw in (("I", 3, {}), ("II", 6, {"noise_level_cond": True})):
        ju = jif.IFUNet(**TINY, in_channels=cin, **kw)
        extra = {"noise_level": jnp.zeros((1,), jnp.int32)} if kw else {}
        p = jax.jit(lambda: ju.init(jax.random.PRNGKey(len(out)), jnp.zeros((1, 16, 16, cin)),
                                    jnp.zeros((1,), jnp.int32), jnp.zeros((1, 4, 16)),
                                    **extra))()
        p = jax.tree.map(np.asarray, p)
        out[stage] = (ju, p, port(tif.IFUNet(**TINY, in_channels=cin, **kw), p))
    return out


@pytest.mark.parametrize("stage", ["I", "II"])
def test_tiny_if_unet(tiny_unets, stage):
    ju, p, tu = tiny_unets[stage]
    rng = np.random.RandomState(3)
    x = randn(rng, 2, 16, 16, ju.in_channels)
    t, ctx = np.array([10, 700]), randn(rng, 2, 5, 16)
    nl = np.array([250, 100]) if stage == "II" else None
    want = ju.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                    None if nl is None else jnp.asarray(nl))
    got = tu(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
             None if nl is None else torch.from_numpy(nl))
    assert got.shape == (2, 16, 16, 6) and got.dtype == torch.float32
    close(got, want)


def jax_steps(jp, p, lat, ctx2, noises, cond=None, nl=None):
    """The JAX pipeline's step loop: its ``_cfg_eps`` (jitted) then
    ``ddpm_learned_range_step`` with the given noise."""
    lat = jnp.asarray(lat)
    cfg_eps = jax.jit(jp._cfg_eps)
    for i, noise in enumerate(noises):
        t, pt = jp._ts[i], jp._prev[i]
        x = lat if cond is None else jnp.concatenate([lat, cond], axis=-1)
        eps, var = cfg_eps(p, x, t, ctx2, nl)
        c = lat.shape[-1]
        lat = jsched.ddpm_learned_range_step(jp.sched, lat, eps[..., :c], var[..., :c], t, pt,
                                             jnp.asarray(noise))
    return np.asarray(lat)


def test_stage_one_steps(tiny_unets):
    ju, p, tu = tiny_unets["I"]
    rng = np.random.RandomState(4)
    steps = 3
    lat, ctx2 = randn(rng, 2, 16, 16, 3), randn(rng, 4, 5, 16)
    noises = [randn(rng, 2, 16, 16, 3) for _ in range(steps)]
    want = jax_steps(jif.IFStageIPipeline(ju, p, steps=steps), p, lat, jnp.asarray(ctx2), noises)
    tp = tif.IFStageIPipeline(tu, steps=steps)
    assert tp._ts == [666, 333, 0] and tp._prev[-1] < 0  # the last step adds no noise
    tp.step_noise = lambda gen, shape, i: torch.from_numpy(noises[i])
    got = tp.denoise(torch.from_numpy(lat), torch.from_numpy(ctx2), None)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * 2)


def test_stage_two_steps(tiny_unets):
    ju, p, tu = tiny_unets["II"]
    rng = np.random.RandomState(5)
    steps, b = 3, 2
    low = np.clip(randn(rng, b, 8, 8, 3), -1, 1)
    cond_noise, lat = randn(rng, b, 16, 16, 3), randn(rng, b, 16, 16, 3)
    ctx2 = randn(rng, 2 * b, 5, 16)
    noises = [randn(rng, b, 16, 16, 3) for _ in range(steps)]
    jp = jif.IFStageIIPipeline(ju, p, steps=steps)
    up = jax.image.resize(jnp.asarray(low), (b, 16, 16, 3), "bilinear")
    cond = jsched.add_noise(jp.sched, up, jnp.asarray(cond_noise), 250)
    nl = jnp.full((b,), 250, jnp.int32)
    want = jax_steps(jp, p, lat, jnp.asarray(ctx2), noises, cond, nl)

    tp = tif.IFStageIIPipeline(tu, steps=steps)
    tcond = tif.add_noise(tp.sched, tif.resize_bilinear(torch.from_numpy(low), 16, 16),
                          torch.from_numpy(cond_noise), 250)
    close(tcond, cond, 1e-6)
    tp.step_noise = lambda gen, shape, i: torch.from_numpy(noises[i])
    got = tp.denoise(torch.from_numpy(lat), tcond, torch.from_numpy(ctx2),
                     torch.full((b,), 250), None)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * 2)


@pytest.mark.parametrize("h,w,scale", [(8, 8, 4), (5, 7, 2), (64, 64, 4)])
def test_bilinear_upscale_matches_jax_resize(h, w, scale):
    x = randn(np.random.RandomState(6), 2, h, w, 3)
    want = jax.image.resize(jnp.asarray(x), (2, h * scale, w * scale, 3), "bilinear")
    got = tif.resize_bilinear(torch.from_numpy(x), h * scale, w * scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # the border rows and columns, where JAX renormalizes and torch clamps
    np.testing.assert_allclose(got.numpy()[:, [0, -1]], np.asarray(want)[:, [0, -1]], atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:, :, [0, -1]], np.asarray(want)[:, :, [0, -1]],
                               atol=1e-6)


def test_generate_shapes_and_range(tiny_unets):
    _, _, tu1 = tiny_unets["I"]
    _, _, tu2 = tiny_unets["II"]
    gen = torch.Generator().manual_seed(0)
    ctx = torch.randn(2, 5, 16, generator=gen)
    img = tif.IFStageIPipeline(tu1, steps=2).generate(gen, ctx, torch.zeros_like(ctx), size=8)
    assert img.shape == (2, 8, 8, 3) and img.abs().max() <= 1.0
    up = tif.IFStageIIPipeline(tu2, steps=2).generate(gen, img, ctx, torch.zeros_like(ctx),
                                                      scale=2)
    assert up.shape == (2, 16, 16, 3) and torch.isfinite(up).all() and up.abs().max() <= 1.0


@pytest.mark.parametrize("name", ["if_i_xl", "if_ii_l"])
def test_release_sizings_parameter_count(name):
    """The full-width UNets (built on ``device="meta"``) hold exactly the
    parameters of the JAX module's tree."""
    ju = getattr(jif.IFUNet, name)()
    kw = {"noise_level": jnp.zeros((1,), jnp.int32)} if ju.noise_level_cond else {}
    shapes = jax.eval_shape(lambda: ju.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 16, 16, ju.in_channels)),
                                            jnp.zeros((1,), jnp.int32),
                                            jnp.zeros((1, 4, ju.encoder_dim)), **kw))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        names, shape = [k.key for k in path], tuple(leaf.shape)
        if names[-1] == "kernel":  # the layouts of params_from_jax, without the arrays
            shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], *shape[:2])
        leaf_name = "weight" if names[-1] in ("kernel", "scale") else names[-1]
        want[".".join(names[:-1] + [leaf_name])] = shape
    tu = getattr(tif.IFUNet, name)(device="meta")
    got = {k: tuple(v.shape) for k, v in tu.state_dict().items()}
    assert got == want
    assert 1.0e9 < sum(np.prod(s) for s in got.values()) < 5.5e9
