"""Device ops: each wraps a hand-written CUDA kernel (``csrc/``) and keeps its
plain torch version beside it, for CPU tensors and as the reference.
``copy_paste``, ``nms``, ``roi_align`` and ``mask_paste`` have no kernel on
either side: they are batched plain torch.

Importing the package registers the ``torch.library`` custom ops of
``window_attention`` (``divergen::window_attention*``), which an exported
program calls."""

from . import window_attention  # noqa: F401
