"""LVIS→Cityscapes cross-dataset instance evaluation.

Counterpart of ``divergen_tpu/evaluation/cityscapes_eval.py``
(``LVISToCityscapesInstanceEvaluator``): an LVIS-vocabulary model's
detections are remapped to the 8 Cityscapes "thing" classes through a
mapping JSON and dumped in the Cityscapes prediction format (a ``*_pred.txt``
per image and an 8-bit gray mask PNG per mapped instance, written by
``utils/png.py`` where the JAX module calls ``cv2.imwrite``); ``evaluate``
scores the dump with ``cityscapesscripts`` when it can be imported and
otherwise with the native scorer (``cityscapes_instance_scoring.py``). Each
mask is pasted with ``lvis_evaluator.paste_mask_np``. Neither package's
``build_evaluator`` builds it: a caller constructs it.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.png import write_png
from .lvis_evaluator import outputs_to_numpy, paste_mask_np

# cityscapes "thing" labels: (name, label_id) with hasInstances and not
# ignoreInEval, in the API's contiguous order
CITYSCAPES_THING_LABELS = [
    ("person", 24),
    ("rider", 25),
    ("car", 26),
    ("truck", 27),
    ("bus", 28),
    ("train", 31),
    ("motorcycle", 32),
    ("bicycle", 33),
]


class LVISToCityscapesInstanceEvaluator:
    """Remap + dump + (optional) cityscapes-API scoring."""

    def __init__(
        self,
        mapper_json: str,
        out_dir: str,
        gt_dir: Optional[str] = None,
    ):
        """``mapper_json``: {lvis_contiguous_id: cityscapes_label_id}
        (datasets/metadata/lvis_to_cityscapes_merge_0.35_results.json in the
        reference); ``out_dir``: prediction dump dir; ``gt_dir``: cityscapes
        gtFine dir for scoring."""
        with open(mapper_json) as f:
            raw = json.load(f)
        label_to_contig = {lid: i for i, (_, lid) in enumerate(CITYSCAPES_THING_LABELS)}
        self.lvis_to_cs = {int(k): label_to_contig[v] for k, v in raw.items()
                           if v in label_to_contig}
        self.out_dir = out_dir
        self.gt_dir = gt_dir
        os.makedirs(out_dir, exist_ok=True)

    def reset(self):
        pass

    def process(self, inputs: List[dict], outputs: Dict[str, np.ndarray]) -> None:
        """inputs: mapper sample dicts (file_name or image_id, tfms, the
        original height and width); outputs: the padded detection dict,
        torch tensors or numpy arrays."""
        outputs = outputs_to_numpy(outputs)
        for b, inp in enumerate(inputs):
            basename = os.path.splitext(os.path.basename(inp.get("file_name", f"{inp['image_id']}")))[0]
            pred_txt = os.path.join(self.out_dir, basename + "_pred.txt")
            valid = np.asarray(outputs["valid"][b])
            boxes = np.asarray(outputs["boxes"][b])[valid]
            scores = np.asarray(outputs["scores"][b])[valid]
            classes = np.asarray(outputs["classes"][b])[valid]
            masks = np.asarray(outputs["mask_logits"][b])[valid] if "mask_logits" in outputs else None
            tfms = inp.get("tfms")
            oh = inp.get("orig_height") or int(inp.get("height", 0))
            ow = inp.get("orig_width") or int(inp.get("width", 0))
            if tfms is not None:
                boxes = tfms.inverse_apply_box(boxes)
            lines = []
            n = 0
            for i in range(len(boxes)):
                cs_contig = self.lvis_to_cs.get(int(classes[i]))
                if cs_contig is None:
                    continue
                name, label_id = CITYSCAPES_THING_LABELS[cs_contig]
                png = os.path.join(self.out_dir, f"{basename}_{n}_{name}.png")
                if masks is not None and oh:
                    prob = 1.0 / (1.0 + np.exp(-masks[i]))
                    m = paste_mask_np(prob, boxes[i], oh, ow).astype(np.uint8)
                    write_png(png, m * 255)
                lines.append(f"{os.path.basename(png)} {label_id} {float(scores[i])}\n")
                n += 1
            with open(pred_txt, "w") as f:
                f.writelines(lines)  # empty file when nothing mapped (ref parity)

    def evaluate(self) -> Optional[Dict[str, Dict[str, float]]]:
        try:
            import cityscapesscripts.evaluation.evalInstanceLevelSemanticLabeling as cs_eval
        except ImportError:
            # score natively (cityscapes_instance_scoring.py implements the
            # published protocol); only give up when there is no GT to read
            if not self.gt_dir:
                return {"segm": {"AP": float("nan"), "AP50": float("nan"),
                                 "note": f"predictions dumped to {self.out_dir}; "
                                         "no gt_dir given for native scoring"}}
            from .cityscapes_instance_scoring import score_prediction_dir

            eval_ids = [lid for _, lid in CITYSCAPES_THING_LABELS]
            try:
                res = score_prediction_dir(self.out_dir, self.gt_dir,
                                           eval_ids=eval_ids)
            except FileNotFoundError as e:
                # a wrong/empty gt_dir must not crash the eval loop at the
                # end of a long run — the dumped predictions stay scoreable
                return {"segm": {"AP": float("nan"), "AP50": float("nan"),
                                 "note": f"native scoring skipped: {e}; "
                                         f"predictions dumped to {self.out_dir}"}}
            return {"segm": {"AP": res["allAp"] * 100,
                             "AP50": res["allAp50%"] * 100,
                             "scorer": "native"}}
        import glob

        cs_eval.args.predictionPath = os.path.abspath(self.out_dir)
        cs_eval.args.predictionWalk = None
        cs_eval.args.JSONOutput = False
        cs_eval.args.colorized = False
        cs_eval.args.gtInstancesFile = os.path.join(self.out_dir, "gtInstances.json")
        gt_list = glob.glob(os.path.join(self.gt_dir, "*", "*_gtFine_instanceIds.png"))
        pred_list = [cs_eval.getPrediction(g, cs_eval.args) for g in gt_list]
        results = cs_eval.evaluateImgLists(pred_list, gt_list, cs_eval.args)["averages"]
        return {"segm": {"AP": results["allAp"] * 100, "AP50": results["allAp50%"] * 100}}
