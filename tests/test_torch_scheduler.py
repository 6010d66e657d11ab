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
