"""Diffusion noise schedules and sampler steps for the SDXL pipeline.

Counterpart of ``divergen_tpu/pipeline/generation/scheduler.py``: the numpy
sigma tables are the same code, and the steps act on torch tensors. Ported
here: the scaled-linear schedule, Euler discrete (SDXL's default) and
DPM-Solver++ 2M in the unscaled sigma parametrization (x = x0 + σ·ε). The
step functions take the step index as a Python int; ``sigmas`` is a 1-D
float32 tensor on the latents' device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


def betas_scaled_linear(n: int = 1000, start: float = 0.00085, end: float = 0.012) -> np.ndarray:
    """SD/SDXL 'scaled_linear' beta schedule."""
    return np.linspace(start**0.5, end**0.5, n, dtype=np.float64) ** 2


class SchedulerConfig(NamedTuple):
    alphas_cumprod: np.ndarray  # (N,)
    num_train_timesteps: int
    prediction_type: str = "epsilon"


def make_scheduler(kind: str = "scaled_linear", n: int = 1000,
                   prediction_type: str = "epsilon",
                   start: float = 0.00085, end: float = 0.012) -> SchedulerConfig:
    if kind != "scaled_linear":
        raise NotImplementedError(f"schedule {kind!r} is not ported yet")
    alphas_cumprod = np.cumprod(1.0 - betas_scaled_linear(n, start, end))
    return SchedulerConfig(alphas_cumprod, n, prediction_type)


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
