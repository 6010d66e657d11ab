"""Build zero-shot classifier weights from CLIP text embeddings of category
names.

Counterpart of ``tools/build_zs_weights.py``: the port's
``ClipEncoder.encode_texts`` (``pipeline/filteration/core.py``) over prompts
made from each category's first synonym, tokenized by the port's copy of
CLIP's tokenizer; ``--clip_ckpt`` loads an openai CLIP checkpoint through the
port's converter (``utils/torch_weights.py:load_clip_params``), else the
towers take seeded random weights. Output: the (num_classes, zs_dim)
L2-normalised float32 ``.npy`` of the reference's on-disk layout
(``modeling/meta_arch/rcnn.py:load_zs_weight`` transposes it on load).

Usage:
  python -m divergen_tpu_torch.tools.build_zs_weights --cat_json cats.json \\
      --out zs.npy [--clip_ckpt ViT-L-14.pt] [--model_name ViT-L/14] \\
      [--bpe_path bpe_simple_vocab_16e6.txt.gz] [--prompt "a {}"] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    from ..modeling.text.tokenizer import SimpleTokenizer
    from ..pipeline.filteration.core import ClipEncoder

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cat_json", required=True, help="LVIS categories json")
    p.add_argument("--out", required=True)
    p.add_argument("--clip_ckpt", default="")
    p.add_argument("--model_name", default="ViT-L/14")
    p.add_argument("--bpe_path", default="")
    p.add_argument("--prompt", default="a {}")
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)

    with open(args.cat_json) as f:
        data = json.load(f)
    cats = sorted(data["categories"] if isinstance(data, dict) else data, key=lambda c: c["id"])
    names = [c.get("synonyms", [c.get("name", "")])[0].replace("_", " ") for c in cats]

    params = None
    if args.clip_ckpt:
        from ..utils.torch_weights import load_clip_params

        params = load_clip_params(args.clip_ckpt, args.model_name)
    enc = ClipEncoder(args.model_name, batch=64, params=params, device=args.device)
    tok = SimpleTokenizer(bpe_path=args.bpe_path) if args.bpe_path else SimpleTokenizer(merges=[])
    prompts = [args.prompt.format(n) for n in names]
    feats = [enc.encode_texts(tok.tokenize(prompts[ofs:ofs + 64]))
             for ofs in range(0, len(prompts), 64)]
    w = np.concatenate(feats)  # (C, zs_dim): the reference's on-disk layout
    np.save(args.out, w.astype(np.float32))
    print(f"zs weights {w.shape} -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
