from .build import (  # noqa: F401
    SolverOptimizer,
    build_lr_schedule,
    build_optimizer,
    ema_update,
    warmup_cosine_lr,
    warmup_multistep_lr,
)
