"""Training / evaluation entry point of the port.

Counterpart of the root ``train_net.py`` (``DiverGen/train_net.py:1-390`` /
``BSGAL/train_net.py``): ``setup`` (config merge, the ``/auto`` OUTPUT_DIR,
freeze), ``do_train`` or, with ``--eval-only``, ``do_test``. One card; the
device is the card unless ``--device`` names another.

    python -m divergen_tpu_torch.train_net --config-file configs/BSGAL_SwinL.yaml \\
        [--resume] [--eval-only] [--max-steps N] [--device cpu] [KEY VALUE ...]

The datasets of ``DATASETS.TRAIN`` / ``TEST`` are the builtin LVIS splits
under ``$DETECTRON2_DATASETS`` (``data/datasets/lvis.py:register_builtin``),
or any name a caller registered before ``main``. ``--multi-host`` raises:
training over several cards or hosts waits for ``torch.distributed``
(ROADMAP.md §1, item 6c).
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
                   help="several hosts (not yet ported: raises)")
    p.add_argument("--device", default=None,
                   help="run on this device (default: the card; 'cpu' to run without one)")
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
    if args.multi_host:
        raise NotImplementedError("--multi-host: training over several hosts is not yet ported "
                                  "(it needs torch.distributed: ROADMAP.md §1 item 6c)")
    cfg = setup(args)

    from .data.datasets.lvis import register_builtin

    register_builtin()

    if args.eval_only:
        from .engine.eval_loop import do_test

        return do_test(cfg, resume=args.resume, device=args.device)

    from .engine.trainer import do_train

    return do_train(cfg, resume=args.resume, max_steps=args.max_steps, device=args.device)


if __name__ == "__main__":
    main(default_argument_parser().parse_args(sys.argv[1:]))
