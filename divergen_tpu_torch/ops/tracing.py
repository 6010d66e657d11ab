"""Whether the port's code is being traced (``torch.export``,
``torch.compile``) rather than run, and how a traced program gets a constant.

A traced program must not read tensor values on the host, and a cache kept
between calls must not keep a tensor made while tracing: it is fake, and an
eager call after the export would get it."""
from __future__ import annotations

from typing import Callable

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing


def tracing() -> bool:
    """True under ``torch.compile`` and inside ``torch.export``'s trace. The
    fake-tensor mode is asked as well as ``is_compiling``: a ``while_loop``
    traced inside an export clears that flag on its way out."""
    return torch.compiler.is_compiling() or detect_fake_mode() is not None


def real(make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``make()`` computed on real tensors even inside an export's trace, so
    that the program holds the result as a constant on its device (made on
    the host and moved inside the trace, it would be copied to the card on
    every call); outside a trace simply ``make()``."""
    if detect_fake_mode() is None:
        return make()
    with unset_fake_temporarily(), disable_proxy_modes_tracing():
        return make()
