#!/usr/bin/env python3
"""How far ``BatchPredictor`` at batch 1, 2 and 8 moves the flagship
detector's results from ``Predictor``'s on one GPU.

The flagship (``graft_entry.flagship_entry()``: Swin-L, 1453 classes, 896²,
bf16, seeded random weights) predicts one 640 x 480 image through
``Predictor`` twice, then through ``BatchPredictor`` with the image
repeated to fill batches of 1, 2 and 8. For each it prints whether the
results equal ``Predictor``'s bit for bit, how many of the 300 detections
pair up (``chip_smoke.same_detections``) and the pairs' largest score
difference, whether the batch's slots agree with each other, and the
largest difference of the FPN pyramid between a batch of 1 and of 8.

    python3 tools/serving_batch_diff.py

Needs a CUDA device; prints the card's name and power limit first.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from divergen_tpu_torch import graft_entry  # noqa: E402
from divergen_tpu_torch.predictor import BatchPredictor, Predictor  # noqa: E402

KEYS = ("boxes", "scores", "classes")


def main() -> int:
    if not torch.cuda.is_available():
        print("serving_batch_diff: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    model, _ = graft_entry.flagship_entry()
    pred = Predictor(graft_entry.flagship_cfg(), model.state_dict())
    del model
    img = chip_smoke.synthetic_image(np.random.RandomState(0), 480, 640)
    ref, again = pred(img), pred(img)
    print(f"Predictor twice: equal {all(np.array_equal(ref[k], again[k]) for k in KEYS)}; "
          f"{len(ref['scores'])} detections, scores {ref['scores'].min():.4f} to "
          f"{ref['scores'].max():.4f}", flush=True)
    for batch in (1, 2, 8):
        outs = [chip_smoke.clipped(o, img.shape[:2])
                for o in BatchPredictor(pred, batch_size=batch)([img] * batch)]
        equal = [all(np.array_equal(o[k], ref[k]) for k in KEYS) for o in outs]
        checks = [chip_smoke.same_detections(o, ref) for o in outs]
        slots = all(np.array_equal(o[k], outs[0][k]) for o in outs for k in KEYS)
        print(f"batch {batch}: equal to Predictor {all(equal)}; paired "
              f"{min(c['pairs'] for c in checks)} of {len(ref['scores'])}, pairs' score gap "
              f"{max(c['score_gap'] for c in checks):.3g} of max |ref|; slots equal to each "
              f"other {slots}", flush=True)
    x, _, _ = pred.preprocess(img)
    with torch.no_grad():
        one = torch.from_numpy(x[None]).cuda()
        f1 = pred.model.backbone_features(one)
        f8 = pred.model.backbone_features(one.expand(8, -1, -1, -1).contiguous())
    gaps = {k: (f1[k][0].float() - f8[k][0].float()).abs().max().item() for k in f1}
    print(f"pyramid, batch 1 against batch 8: max |diff| {gaps}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
