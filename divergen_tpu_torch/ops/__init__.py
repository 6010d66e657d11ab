"""Device ops: each wraps a hand-written CUDA kernel (``csrc/``) and keeps its
plain torch version beside it, for CPU tensors and as the reference.
``copy_paste``, ``nms``, ``roi_align`` and ``mask_paste`` have no kernel on
either side: they are batched plain torch."""
