"""Command-line tools of the port, each run as ``python -m
divergen_tpu_torch.tools.<name>``: the counterparts of the root ``tools/``
scripts that import the JAX package (``export_model``,
``import_reference_checkpoint``, ``convert_imgnet_model_to_lvis``,
``build_zs_weights``). Each ``main(argv)`` takes an argument list."""
