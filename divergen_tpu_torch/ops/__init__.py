"""Device ops: each wraps a hand-written CUDA kernel (``csrc/``) and keeps its
plain torch version beside it, for CPU tensors and as the reference.
``copy_paste`` has no kernel on either side: it is batched plain torch."""
