"""Training / evaluation entry point of the port.

Counterpart of the root ``train_net.py`` (``DiverGen/train_net.py:1-390`` /
``BSGAL/train_net.py``): ``setup`` (config merge, the ``/auto`` OUTPUT_DIR,
freeze), ``do_train`` or, with ``--eval-only``, ``do_test``. The device is
the card unless ``--device`` names another.

    python -m divergen_tpu_torch.train_net --config-file configs/BSGAL_SwinL.yaml \\
        [--resume] [--eval-only] [--max-steps N] [--device cpu] [KEY VALUE ...]

Over several cards, one process a card, ``--multi-host`` joins the process
group ``torchrun`` describes (``utils/dist.py:init_distributed``, as the JAX
``train_net --multi-host`` calls ``jax.distributed.initialize()``): NCCL on
the cards, gloo with ``--device cpu`` or ``--dist-backend gloo``.

    torchrun --nproc_per_node=N -m divergen_tpu_torch.train_net --multi-host \\
        --config-file configs/BSGAL_SwinL.yaml [KEY VALUE ...]

The datasets of ``DATASETS.TRAIN`` / ``TEST`` are the builtin LVIS splits
under ``$DETECTRON2_DATASETS`` (``data/datasets/lvis.py:register_builtin``),
or any name a caller registered before ``main``.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys


def default_argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="divergen_tpu_torch training")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--max-steps", type=int, default=None, help="cap iterations (smoke runs)")
    p.add_argument("--multi-host", action="store_true",
                   help="join the torchrun process group (utils.dist.init_distributed)")
    p.add_argument("--dist-backend", default=None,
                   help="with --multi-host: the backend (default: nccl on the card, gloo on the "
                        "CPU; gloo lets several ranks share one card)")
    p.add_argument("--device", default=None,
                   help="run on this device (default: the card, with --multi-host "
                        "cuda:LOCAL_RANK; 'cpu' to run without one)")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p


def setup(args):
    """The frozen config: defaults, the file, then the ``KEY VALUE`` pairs;
    an OUTPUT_DIR ending in ``/auto`` takes the config file's name."""
    from .config import get_cfg

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    # '/auto' OUTPUT_DIR templating (train_net.py:320-327)
    if cfg.OUTPUT_DIR.endswith("/auto") and args.config_file:
        name = os.path.splitext(os.path.basename(args.config_file))[0]
        cfg.OUTPUT_DIR = cfg.OUTPUT_DIR[: -len("auto")] + name
    cfg.freeze()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    return cfg


def main(args):
    """``do_test``'s results with ``--eval-only``, else ``do_train``'s state."""
    device = args.device
    if args.multi_host:
        from .utils.dist import init_distributed

        device = init_distributed(args.dist_backend, device=args.device)
    elif args.dist_backend:
        raise ValueError("--dist-backend is an option of --multi-host")
    cfg = setup(args)

    from .data.datasets.lvis import register_builtin

    register_builtin()

    if args.eval_only:
        from .engine.eval_loop import do_test

        from .parallel.mesh import create_mesh

        group = create_mesh(cfg.PARALLEL.DATA_PARALLEL, cfg.PARALLEL.MODEL_PARALLEL).group
        return do_test(cfg, resume=args.resume, device=device, group=group)

    from .engine.trainer import do_train

    return do_train(cfg, resume=args.resume, max_steps=args.max_steps, device=device)


if __name__ == "__main__":
    main(default_argument_parser().parse_args(sys.argv[1:]))
