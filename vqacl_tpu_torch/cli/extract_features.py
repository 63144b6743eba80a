"""Offline region-feature extraction entry point.

Counterpart of ``vqacl_tpu/cli/extract_features.py`` (reference:
feature_extraction/coco_proposal.py and the other per-dataset scripts
writing ``*_obj36.h5``). The per-image pipeline is ``vision/frcnn.py``
on the card; the output is the reference h5 schema, the native pack
(``--pack``) or Apache Arrow (``--arrow``).

    python -m vqacl_tpu_torch.cli.extract_features \
        --images /path/to/val2014 --out val2014_obj36.h5 \
        --weights frcnn_vg.npz [--pack]

``--platform auto`` (the default) runs on the CUDA card and raises
without one; ``--platform cpu`` runs the plain path on the host. The
image decoders need PIL and the h5 writer h5py; ``build_source`` and
``records`` also run over decoded arrays, with ``--pack`` output and no
PIL or h5py at all.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

# (img_id, BGR uint8 image [H,W,3], boxes [R,4] in image pixels | None)
Triple = Tuple[str, np.ndarray, Optional[np.ndarray]]


def iter_images(image_dir: str) -> Iterator[Tuple[str, np.ndarray]]:
    from PIL import Image
    for name in sorted(os.listdir(image_dir)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        img_id = os.path.splitext(name)[0]
        rgb = np.asarray(Image.open(
            os.path.join(image_dir, name)).convert("RGB"))
        yield img_id, rgb[:, :, ::-1]  # BGR, caffe convention


def iter_dataset_images(items) -> Iterator[Triple]:
    """(img_id, path, boxes|None) items → (img_id, BGR image, boxes)."""
    from PIL import Image
    for img_id, path, boxes in items:
        rgb = np.asarray(Image.open(path).convert("RGB"))
        yield img_id, rgb[:, :, ::-1], boxes


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--images", default=None,
                   help="plain image directory (the default source)")
    p.add_argument("--dataset", default=None,
                   choices=["coco", "flickr30k", "vcr", "refcocog",
                            "refcocog_mattnet"],
                   help="dataset-specific enumeration (the reference's "
                        "per-dataset scripts: coco/flickr30k/vcr/refcocog/"
                        "refcocog_mattnet)")
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--split", default=None)
    p.add_argument("--gt", action="store_true",
                   help="use the dataset's GT boxes (the *_gt.py scripts) "
                        "instead of RPN proposals")
    p.add_argument("--coco_images", default=None,
                   help="COCO image dir for refcocog (its images live in "
                        "COCO train2014)")
    p.add_argument("--out", required=True)
    p.add_argument("--weights", default=None,
                   help="npz of converted detector weights (random if unset)")
    p.add_argument("--n_boxes", type=int, default=36)
    p.add_argument("--pack", action="store_true",
                   help="write native .vfpack instead of h5")
    p.add_argument("--arrow", action="store_true",
                   help="write Apache Arrow (the reference's "
                        "inference/extracting_data.py schema)")
    p.add_argument("--boxes_json", default=None,
                   help="given-box mode ({img_id: [[x1,y1,x2,y2],...]}):"
                        " RoI features at the provided GT boxes instead of"
                        " RPN proposals (reference *_gt.py scripts)")
    p.add_argument("--platform", default="auto",
                   choices=["auto", "cuda", "cpu"],
                   help="the device: auto and cuda = the CUDA card (an "
                        "error without one), cpu = the plain PyTorch path "
                        "on the host")
    return p.parse_args(argv)


def load_params(weights: Optional[str], device):
    """The detector from ``--weights`` (an npz of either package), or the
    seeded random init when unset."""
    from vqacl_tpu_torch.vision import frcnn
    from vqacl_tpu_torch.vision.convert_weights import load_npz_params

    if weights:
        return load_npz_params(weights, device)
    print("WARNING: no --weights given; using random detector weights")
    return frcnn.init_frcnn(0, device)


def build_source(args: argparse.Namespace) -> Iterator[Triple]:
    """The (img_id, BGR image, boxes|None) triples the flags name:
    ``--dataset`` enumeration, or the ``--images`` directory (with
    ``--boxes_json``, only the images it lists, at its boxes)."""
    if args.dataset:
        from vqacl_tpu_torch.vision.datasets import enumerate_dataset
        assert args.dataset_root, "--dataset needs --dataset_root"
        return iter_dataset_images(enumerate_dataset(
            args.dataset, args.dataset_root, args.split, gt=args.gt,
            coco_images_dir=args.coco_images))
    assert args.images, "need --images or --dataset"
    given_boxes = None
    if args.boxes_json:
        with open(args.boxes_json) as f:
            given_boxes = json.load(f)

    def dir_source():
        for img_id, bgr in iter_images(args.images):
            if given_boxes is not None:
                if img_id not in given_boxes:
                    continue
                yield img_id, bgr, np.asarray(given_boxes[img_id],
                                              np.float32)
            else:
                yield img_id, bgr, None
    return dir_source()


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def records(params, source: Iterable[Triple], n_boxes: int = 36,
            device="cuda") -> Iterator[Tuple[str, dict]]:
    """(img_id, h5 record) for each triple, with ``params`` on
    ``device``: the RPN pipeline (``frcnn.extract_image``), or RoI
    features at the given boxes (padded to ``n_boxes`` by repeating the
    last, scaled with the resize; the record keeps the original
    boxes)."""
    from vqacl_tpu_torch.utils.device import resolve_device
    from vqacl_tpu_torch.vision import frcnn

    dev = resolve_device(device)
    for img_id, bgr, boxes in source:
        if boxes is not None:
            boxes = np.asarray(boxes, np.float32)
            pad = n_boxes - len(boxes)
            if pad > 0:
                boxes = np.concatenate(
                    [boxes, np.tile(boxes[-1:], (pad, 1))], axis=0)
            boxes = boxes[:n_boxes]
            resized, scale = frcnn.resize_shortest_edge(
                bgr.astype(np.float32))
            feats, obj_id, obj_conf = frcnn.extract_given_boxes(
                params, torch.from_numpy(frcnn.pad_to_bucket(resized)).to(dev),
                torch.from_numpy(boxes * scale).to(dev))
            rec = {"features": _np(feats).astype(np.float32),
                   "boxes": boxes,
                   "img_h": bgr.shape[0], "img_w": bgr.shape[1],
                   "obj_id": _np(obj_id).astype(np.int32),
                   "obj_conf": _np(obj_conf)}
        else:
            rec = frcnn.extract_image(params, bgr, n_boxes=n_boxes)
        yield img_id, rec


def write(args: argparse.Namespace, recs: Iterable[Tuple[str, dict]]
          ) -> None:
    """Records → ``--out`` in the format the flags pick."""
    if args.arrow:
        from vqacl_tpu_torch.data.arrow_store import write_arrow
        write_arrow(args.out, recs, n_boxes=args.n_boxes)
    elif args.pack:
        from vqacl_tpu_torch.data.packed_cache import write_pack
        write_pack(args.out,
                   ((i, r["features"], r["boxes"], r["img_h"], r["img_w"])
                    for i, r in recs),
                   n_boxes=args.n_boxes)
    else:
        from vqacl_tpu_torch.data.features import write_h5
        write_h5(args.out, recs)


def main(argv=None) -> None:
    args = parse_args(argv)
    from vqacl_tpu_torch.cli.args import platform_device

    device = platform_device(args.platform)
    params = load_params(args.weights, device)
    write(args, records(params, build_source(args), args.n_boxes, device))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main(sys.argv[1:])
