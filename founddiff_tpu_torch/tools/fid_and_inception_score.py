"""FID of generated ``.npy`` slices against a reference directory, on
Dose-CLIP features (mirror of ``fid_and_inception_score.py``):

    python -m founddiff_tpu_torch.tools.fid_and_inception_score <generated_dir> \\
        --reference_dir DIR --clip_weights Dose-CLIP.pth [--device cuda]

The feature tower is required: FID over randomly initialized features means
little, so without one the tool refuses, as the JAX script does.
``--clip_weights`` is a torch Dose-CLIP / CLIPIQA state dict, loaded as it
is; ``--flax_params`` a pickled CLIPIQA param tree of numpy arrays, mapped
through ``from_jax_params`` (a pickle of JAX arrays cannot be read without
JAX and is refused).  ``--bpe_path`` derives the prompts' EOT positions.
One JSON line: ``fid_doseclip``, ``feature_extractor``, ``n_generated``,
``n_reference``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import sys

import numpy as np

REFUSAL = ("FID requires pretrained extractor features: pass --clip_weights (torch Dose-CLIP "
           "checkpoint) or --flax_params. Refusing to score with randomly initialized "
           "features.")


def load_dir(path: str, limit: int = 2048) -> np.ndarray:
    files = sorted(glob.glob(os.path.join(path, "*.npy")))[:limit]
    if not files:
        raise SystemExit(f"no .npy files in {path}")
    arrs = []
    for f in files:
        a = np.load(f).astype(np.float32)
        if a.ndim == 2:
            a = a[..., None]
        arrs.append(a)
    return np.stack(arrs)


class _NumpyOnly(pickle.Unpickler):
    """Unpickles numpy arrays and plain containers; a JAX array would need
    JAX itself, which this package does not import."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise SystemExit(f"{self.path} holds JAX arrays ({module}.{name}), which cannot be "
                             "read without JAX: save the tree with numpy.asarray leaves")
        return super().find_class(module, name)


def read_param_pickle(path: str):
    with open(path, "rb") as f:
        u = _NumpyOnly(f)
        u.path = path
        return u.load()


def load_extractor(args, tower) -> None:
    """Pretrained CLIPIQA weights into ``tower``, or the refusal."""
    from founddiff_tpu_torch.utils.clip_build import load_clipiqa, load_torch_state
    from founddiff_tpu_torch.utils.convert import from_jax_params

    if args.flax_params:
        tower.load_state_dict(from_jax_params(read_param_pickle(args.flax_params)), strict=True)
        return
    if args.clip_weights:
        # a reference file's other tensor, the text token embedding, is not the tower's
        try:
            load_clipiqa(tower, load_torch_state(args.clip_weights),
                         source=f"checkpoint {args.clip_weights}")
        except ValueError as e:
            raise SystemExit(str(e)) from None
        print(f"loaded {len(tower.state_dict())} tensors from {args.clip_weights}",
              file=sys.stderr)
        return
    raise SystemExit(REFUSAL)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("generated_dir")
    p.add_argument("--reference_dir", default=None,
                   help="ground-truth slice dir (defaults to generated_dir, yielding FID 0 as "
                        "a smoke check)")
    p.add_argument("--limit", type=int, default=2048)
    p.add_argument("--clip_weights", default=None,
                   help="torch Dose-CLIP/CLIPIQA state dict for the feature tower")
    p.add_argument("--flax_params", default=None,
                   help="pickled CLIPIQA param tree of numpy arrays")
    p.add_argument("--bpe_path", default=os.environ.get("FOUNDDIFF_CLIP_BPE"),
                   help="bpe_simple_vocab_16e6.txt.gz; when given, the prompt EOT indices are "
                        "derived from the tokenizer instead of the (24, 25) default")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; 'cpu' runs on the host)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from founddiff_tpu_torch.models.clip import CLIPIQA
    from founddiff_tpu_torch.utils.device import resolve
    from founddiff_tpu_torch.utils.fid import compute_fid, make_clip_extractor

    gen = load_dir(args.generated_dir, args.limit)
    ref = load_dir(args.reference_dir or args.generated_dir, args.limit)
    tower_kw = {}
    if args.bpe_path and os.path.exists(args.bpe_path):
        # FID reads encode_image alone; the tower still gets the true EOT
        # positions, so that its dose probability is right too
        from founddiff_tpu_torch.models.tokenizer import CT_PROMPTS, ClipTokenizer

        tok = ClipTokenizer(bpe_path=args.bpe_path)
        prefix = " ".join(["X"] * 16) + " "
        ids = tok.tokenize([prefix + p for p in CT_PROMPTS], 77)
        eot = tuple(int(i) for i in ids.argmax(axis=-1))
        tower_kw = dict(prompt_eot_indices=eot)
        print(f"derived prompt EOT indices {eot} from {args.bpe_path}", file=sys.stderr)
    tower = CLIPIQA(**tower_kw)
    load_extractor(args, tower)
    tower.to(resolve(args.device, "fid_and_inception_score")).eval()
    fid = compute_fid(gen, ref, make_clip_extractor(tower))
    # fid_doseclip, not fid: Dose-CLIP features, not InceptionV3's; not
    # comparable with published FIDs
    out = {
        "fid_doseclip": fid,
        "feature_extractor": "dose-clip-visual (not InceptionV3; value is not comparable to "
                             "published FIDs)",
        "n_generated": len(gen),
        "n_reference": len(ref),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
