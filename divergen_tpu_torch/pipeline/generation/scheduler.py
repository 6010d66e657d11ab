"""Diffusion noise schedules and sampler steps for the SDXL pipeline.

Counterpart of ``divergen_tpu/pipeline/generation/scheduler.py``: the numpy
sigma tables are the same code, and the steps act on torch tensors. The
scaled-linear (SD/SDXL) and cosine (DeepFloyd-IF) schedules, the forward
process ``add_noise``, DDIM (``v_prediction`` too), Euler discrete (SDXL's
default), DPM-Solver++ 2M in the unscaled sigma parametrization (x = x0 +
σ·ε), and the ancestral DDPM step with the learned-range variance and dynamic
thresholding of the IF stages. The step functions take the step index (or
the timesteps) as Python ints; ``sigmas`` is a 1-D float32 tensor on the
latents' device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


def betas_scaled_linear(n: int = 1000, start: float = 0.00085, end: float = 0.012) -> np.ndarray:
    """SD/SDXL 'scaled_linear' beta schedule."""
    return np.linspace(start**0.5, end**0.5, n, dtype=np.float64) ** 2


def betas_cosine(n: int = 1000, s: float = 0.008) -> np.ndarray:
    """squaredcos_cap_v2 (DeepFloyd-IF)."""
    t = np.arange(n + 1, dtype=np.float64) / n
    f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
    betas = 1 - f[1:] / f[:-1]
    return np.clip(betas, 0, 0.999)


class SchedulerConfig(NamedTuple):
    alphas_cumprod: np.ndarray  # (N,)
    num_train_timesteps: int
    prediction_type: str = "epsilon"  # epsilon | v_prediction


def make_scheduler(kind: str = "scaled_linear", n: int = 1000,
                   prediction_type: str = "epsilon",
                   start: float = 0.00085, end: float = 0.012) -> SchedulerConfig:
    """``kind`` "cosine" is IF's schedule; any other is scaled-linear from
    ``start`` to ``end``, as in the JAX package."""
    betas = betas_cosine(n) if kind == "cosine" else betas_scaled_linear(n, start, end)
    return SchedulerConfig(np.cumprod(1.0 - betas), n, prediction_type)


def _abar(cfg: SchedulerConfig, t: int, like: torch.Tensor) -> torch.Tensor:
    """ᾱ_t as a float32 0-d tensor on ``like``'s device; 1 for t < 0 (the
    step after the last)."""
    value = np.float32(cfg.alphas_cumprod[t]) if t >= 0 else np.float32(1.0)
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def add_noise(cfg: SchedulerConfig, sample: torch.Tensor, noise: torch.Tensor,
              t: int) -> torch.Tensor:
    """DDPMScheduler.add_noise: sqrt(ᾱ_t)·x + sqrt(1-ᾱ_t)·ε."""
    ac = _abar(cfg, int(t), sample)
    return torch.sqrt(ac) * sample + torch.sqrt(1.0 - ac) * noise


# ---------------- DDIM ----------------
def ddim_timesteps(cfg: SchedulerConfig, steps: int) -> np.ndarray:
    ratio = cfg.num_train_timesteps // steps
    return (np.arange(steps) * ratio).round()[::-1].astype(np.int64)


def ddim_step(cfg: SchedulerConfig, latents: torch.Tensor, eps: torch.Tensor, t: int,
              t_prev: int, eta: float = 0.0) -> torch.Tensor:
    """Deterministic DDIM from timestep ``t`` to ``t_prev`` (< 0: the end)."""
    a_t, a_prev = _abar(cfg, int(t), latents), _abar(cfg, int(t_prev), latents)
    if cfg.prediction_type == "v_prediction":
        x0 = torch.sqrt(a_t) * latents - torch.sqrt(1 - a_t) * eps
        eps = torch.sqrt(a_t) * eps + torch.sqrt(1 - a_t) * latents
    else:
        x0 = (latents - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps


# ---------------- Euler discrete (SDXL default) ----------------
def euler_sigmas(cfg: SchedulerConfig, steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps (S,), sigmas (S+1,)) with linspace timestep spacing."""
    ac = cfg.alphas_cumprod
    sigmas_full = np.sqrt((1 - ac) / ac)
    ts = np.linspace(0, cfg.num_train_timesteps - 1, steps, dtype=np.float64)[::-1].copy()
    sig = np.interp(ts, np.arange(len(sigmas_full)), sigmas_full)
    return ts, np.concatenate([sig, [0.0]]).astype(np.float32)


def euler_scale_input(latents: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return latents / torch.sqrt(sigma**2 + 1.0)


def euler_step(latents: torch.Tensor, eps: torch.Tensor, sigma: torch.Tensor,
               sigma_next: torch.Tensor) -> torch.Tensor:
    """Deterministic Euler: x ← x + (σ₊ − σ)·d, d = (x − x₀̂)/σ = eps."""
    pred_x0 = latents - sigma * eps
    d = (latents - pred_x0) / torch.clamp(sigma, min=1e-9)
    return latents + (sigma_next - sigma) * d


def euler_init_noise_scale(sigmas: np.ndarray) -> float:
    return float(sigmas[0])


# ---------------- DPM-Solver++ 2M (multistep) ----------------
def dpmpp_timesteps_sigmas(cfg: SchedulerConfig, steps: int,
                           karras: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps (S,), sigmas (S+1,), last sigma 0): diffusers 'linspace'
    spacing for the multistep solver, S+1 rounded points with the last dropped."""
    ac = cfg.alphas_cumprod
    sigmas_full = np.sqrt((1 - ac) / ac)
    ts = (
        np.linspace(0, cfg.num_train_timesteps - 1, steps + 1)
        .round()[::-1][:-1]
        .copy()
        .astype(np.float64)
    )
    sig = np.interp(ts, np.arange(len(sigmas_full)), sigmas_full)
    if karras:
        # diffusers _convert_to_karras (rho=7) + _sigma_to_t log-interp
        rho = 7.0
        smin, smax = sig[-1], sig[0]
        ramp = np.linspace(0, 1, steps)
        sig = (smax ** (1 / rho) + ramp * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
        log_full = np.log(sigmas_full)
        ts = np.interp(np.log(sig), log_full, np.arange(len(sigmas_full)))
    return ts, np.concatenate([sig, [0.0]]).astype(np.float32)


def dpmpp_init_noise_scale(sigmas: np.ndarray) -> float:
    """Unscaled-space initial noise: 1/α₀ = √(σ₀²+1)."""
    return float(np.sqrt(float(sigmas[0]) ** 2 + 1.0))


def dpmpp_2m_step(latents: torch.Tensor, pred_x0: torch.Tensor,
                  pred_x0_prev: torch.Tensor, i: int, sigmas: torch.Tensor,
                  num_steps: int) -> torch.Tensor:
    """One DPM-Solver++ 2M update in unscaled space. First-order at i == 0
    (no history) and at the final step (σ₊ = 0, diffusers'
    final_sigmas_type="zero"); midpoint second-order elsewhere."""
    sig = sigmas[i]
    sig_next = sigmas[i + 1]
    r = sig_next / torch.clamp(sig, min=1e-20)
    if i == 0 or i == num_steps - 1:
        x0_eff = pred_x0
    else:
        # h = λ₊−λ = log(σ/σ₊); h₀ = λ−λ₋ = log(σ₋/σ); r0 = h₀/h
        sig_prev = sigmas[i - 1]
        h = torch.log(sig) - torch.log(torch.clamp(sig_next, min=1e-20))
        h0 = torch.log(sig_prev) - torch.log(sig)
        d1 = (pred_x0 - pred_x0_prev) / (h0 / h)
        x0_eff = pred_x0 + 0.5 * d1
    return r * latents + (1.0 - r) * x0_eff


# ---------------- DDPM, learned-range variance (DeepFloyd-IF stages) -------
# The diffusers DDPMScheduler of the IF pipelines (variance_type=
# "learned_range", thresholding, squaredcos_cap_v2 betas). The UNet emits 2·C
# channels: ε and a per-pixel interpolant v ∈ [−1, 1] between the posterior
# (min) and β_t (max) log-variances.


def ddpm_timesteps(cfg: SchedulerConfig, steps: int) -> np.ndarray:
    """DDPMScheduler.set_timesteps 'leading' spacing."""
    ratio = cfg.num_train_timesteps // steps
    return (np.arange(steps) * ratio).round()[::-1].astype(np.int64)


def dynamic_threshold(x0: torch.Tensor, ratio: float = 0.95,
                      max_value: float = 1.5) -> torch.Tensor:
    """diffusers _threshold_sample: per-sample abs-quantile s (clamped to
    [1, max_value]), clip to ±s and rescale into [−1, 1]. The quantile
    interpolates linearly between the sorted neighbours, as ``jnp.quantile``
    does (sorted here: ``torch.quantile`` refuses inputs above 2^24
    elements)."""
    b = x0.shape[0]
    flat = x0.reshape(b, -1).abs().float().sort(dim=1).values
    n = flat.shape[1]
    pos = torch.tensor(ratio, dtype=torch.float32) * (n - 1)
    low, high = int(torch.floor(pos)), int(torch.ceil(pos))
    w_high = (pos - low).to(x0.device)
    s = flat[:, low] * (1.0 - w_high) + flat[:, high] * w_high
    s = s.clamp(1.0, max_value).reshape((b,) + (1,) * (x0.dim() - 1))
    return torch.maximum(torch.minimum(x0, s), -s) / s


def ddpm_learned_range_step(cfg: SchedulerConfig, latents: torch.Tensor, eps: torch.Tensor,
                            var_pred: torch.Tensor, t: int, prev_t: int, noise: torch.Tensor,
                            thresholding: bool = True, threshold_ratio: float = 0.95,
                            threshold_max: float = 1.5) -> torch.Tensor:
    """One ancestral DDPM step with the learned-range variance
    (DDPMScheduler.step). ``prev_t < 0`` means the final step (ᾱ_prev = 1);
    at ``t == 0`` no noise is added."""
    abar_t, abar_prev = _abar(cfg, int(t), latents), _abar(cfg, int(prev_t), latents)
    current_alpha = abar_t / abar_prev
    current_beta = 1.0 - current_alpha

    x0 = (latents - torch.sqrt(1.0 - abar_t) * eps) / torch.sqrt(abar_t)
    if thresholding:
        x0 = dynamic_threshold(x0, threshold_ratio, threshold_max)
    coef_x0 = torch.sqrt(abar_prev) * current_beta / (1.0 - abar_t)
    coef_xt = torch.sqrt(current_alpha) * (1.0 - abar_prev) / (1.0 - abar_t)
    mean = coef_x0 * x0 + coef_xt * latents
    if int(t) <= 0:
        return mean.to(latents.dtype)
    posterior_var = (1.0 - abar_prev) / (1.0 - abar_t) * current_beta
    min_log = torch.log(torch.clamp(posterior_var, min=1e-20))
    max_log = torch.log(torch.clamp(current_beta, min=1e-20))
    frac = (var_pred.float() + 1.0) / 2.0
    log_var = frac * max_log + (1.0 - frac) * min_log
    return (mean + torch.exp(0.5 * log_var) * noise).to(latents.dtype)
