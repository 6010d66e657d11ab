"""The port's scheduler against the JAX scheduler: sigma tables and the
Euler / DPM-Solver++ 2M steps on the same numpy inputs, to 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.pipeline.generation import scheduler as js
from divergen_tpu_torch.pipeline.generation import scheduler as ts

torch.set_num_threads(1)


@pytest.mark.parametrize("steps", [4, 25, 50])
def test_sigma_tables(steps):
    jcfg, tcfg = js.make_scheduler("scaled_linear"), ts.make_scheduler("scaled_linear")
    np.testing.assert_allclose(tcfg.alphas_cumprod, jcfg.alphas_cumprod, rtol=1e-12)
    for jf, tf in ((js.euler_sigmas, ts.euler_sigmas),
                   (js.dpmpp_timesteps_sigmas, ts.dpmpp_timesteps_sigmas)):
        (jt, jsig), (tt, tsig) = jf(jcfg, steps), tf(tcfg, steps)
        np.testing.assert_allclose(tt, jt, rtol=1e-6)
        np.testing.assert_allclose(tsig, jsig, rtol=1e-6)
    _, sig = ts.dpmpp_timesteps_sigmas(tcfg, steps)
    assert ts.dpmpp_init_noise_scale(sig) == pytest.approx(js.dpmpp_init_noise_scale(sig), rel=1e-6)
    assert ts.euler_init_noise_scale(sig) == js.euler_init_noise_scale(sig)


def test_euler_scale_and_step():
    rng = np.random.RandomState(0)
    lat, eps = rng.randn(2, 4, 4, 4).astype(np.float32), rng.randn(2, 4, 4, 4).astype(np.float32)
    _, sig = ts.euler_sigmas(ts.make_scheduler(), 5)
    for i in range(5):
        s, s1 = np.float32(sig[i]), np.float32(sig[i + 1])
        want = js.euler_step(jnp.asarray(lat), jnp.asarray(eps), jnp.asarray(s), jnp.asarray(s1))
        got = ts.euler_step(torch.from_numpy(lat), torch.from_numpy(eps), torch.tensor(s),
                            torch.tensor(s1))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        want = js.euler_scale_input(jnp.asarray(lat), jnp.asarray(s))
        got = ts.euler_scale_input(torch.from_numpy(lat), torch.tensor(s))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_dpmpp_2m_step():
    rng = np.random.RandomState(1)
    steps = 6
    _, sig = ts.dpmpp_timesteps_sigmas(ts.make_scheduler(), steps)
    lat = rng.randn(1, 4, 4, 4).astype(np.float32)
    x0_prev = np.zeros_like(lat)
    for i in range(steps):
        x0 = rng.randn(*lat.shape).astype(np.float32)
        want = js.dpmpp_2m_step(jnp.asarray(lat), jnp.asarray(x0), jnp.asarray(x0_prev),
                                jnp.asarray(i), jnp.asarray(sig), steps)
        got = ts.dpmpp_2m_step(torch.from_numpy(lat), torch.from_numpy(x0),
                               torch.from_numpy(x0_prev), i, torch.from_numpy(sig), steps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        lat, x0_prev = np.array(want), x0


def test_cosine_schedule_and_ddpm_timesteps():
    jcfg, tcfg = js.make_scheduler("cosine"), ts.make_scheduler("cosine")
    np.testing.assert_allclose(tcfg.alphas_cumprod, jcfg.alphas_cumprod, rtol=1e-12)
    np.testing.assert_array_equal(ts.betas_cosine(), js.betas_cosine())
    for steps in (3, 4, 50, 100):
        np.testing.assert_array_equal(ts.ddpm_timesteps(tcfg, steps), js.ddpm_timesteps(jcfg, steps))
        np.testing.assert_array_equal(ts.ddim_timesteps(tcfg, steps), js.ddim_timesteps(jcfg, steps))


@pytest.mark.parametrize("kind", ["cosine", "scaled_linear"])
def test_add_noise(kind):
    rng = np.random.RandomState(2)
    x, noise = rng.randn(2, 4, 4, 3).astype(np.float32), rng.randn(2, 4, 4, 3).astype(np.float32)
    jcfg, tcfg = js.make_scheduler(kind, start=1e-4, end=2e-2), ts.make_scheduler(kind, start=1e-4, end=2e-2)
    for t in (0, 100, 250, 999):
        want = js.add_noise(jcfg, jnp.asarray(x), jnp.asarray(noise), t)
        got = ts.add_noise(tcfg, torch.from_numpy(x), torch.from_numpy(noise), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddim_step(prediction_type):
    rng = np.random.RandomState(3)
    jcfg = js.make_scheduler("cosine", prediction_type=prediction_type)
    tcfg = ts.make_scheduler("cosine", prediction_type=prediction_type)
    lat = rng.randn(2, 4, 4, 3).astype(np.float32)
    steps = ts.ddim_timesteps(tcfg, 4)
    for t, t_prev in zip(steps, list(steps[1:]) + [-1]):
        eps = rng.randn(*lat.shape).astype(np.float32)
        want = js.ddim_step(jcfg, jnp.asarray(lat), jnp.asarray(eps), jnp.asarray(t),
                            jnp.asarray(t_prev))
        got = ts.ddim_step(tcfg, torch.from_numpy(lat), torch.from_numpy(eps), int(t), int(t_prev))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        lat = np.array(want)


@pytest.mark.parametrize("shape,ratio", [((2, 4, 4, 3), 0.95), ((3, 7, 5, 3), 0.9),
                                         ((1, 16, 16, 3), 0.5)])
def test_dynamic_threshold(shape, ratio):
    x = np.random.RandomState(4).randn(*shape).astype(np.float32) * 1.6
    want = js.dynamic_threshold(jnp.asarray(x), ratio, 1.5)
    got = ts.dynamic_threshold(torch.from_numpy(x), ratio, 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("thresholding", [True, False])
def test_ddpm_learned_range_step(thresholding):
    """Every step of a 4-step schedule, the last (t = 0) without noise."""
    rng = np.random.RandomState(5)
    jcfg, tcfg = js.make_scheduler("cosine"), ts.make_scheduler("cosine")
    steps = ts.ddpm_timesteps(tcfg, 4)
    lat = rng.randn(2, 4, 4, 3).astype(np.float32)
    for t in steps:
        prev = int(t) - 250
        eps, noise = (rng.randn(*lat.shape).astype(np.float32) for _ in range(2))
        var = rng.uniform(-1, 1, lat.shape).astype(np.float32)
        want = js.ddpm_learned_range_step(jcfg, jnp.asarray(lat), jnp.asarray(eps),
                                          jnp.asarray(var), jnp.asarray(t), jnp.asarray(prev),
                                          jnp.asarray(noise), thresholding=thresholding)
        got = ts.ddpm_learned_range_step(tcfg, torch.from_numpy(lat), torch.from_numpy(eps),
                                         torch.from_numpy(var), int(t), prev,
                                         torch.from_numpy(noise), thresholding=thresholding)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        lat = np.array(want)
