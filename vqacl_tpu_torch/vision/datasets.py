"""Dataset-specific extraction enumerators.

The reference ships eight thin per-dataset scripts around one shared
extractor (``feature_extraction/{coco,flickr30k,vcr,refcocog}_*.py``):
each enumerates (img_id, image_path[, gt_boxes]) from that dataset's
annotation layout and feeds the RPN-proposal or given-box pipeline.
This module provides the same enumerations for the port's extractor
(``cli/extract_features.py --dataset ...``), without DataLoaders or
pycocotools — the annotation formats are plain json/jsonl/pickle. It is
the JAX package's ``vision/datasets.py`` as it is (paths, json and
pickle only).

Box convention: returned GT boxes are pixel (x1, y1, x2, y2), matching
``detectron2_given_box_maxnms.py``'s input.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

Item = Tuple[str, str, Optional[np.ndarray]]   # (img_id, path, boxes|None)

COCO_SPLIT2DIR = {"train": "train2014", "valid": "val2014",
                  "test": "test2015"}                 # coco_proposal.py:43-47
FLICKR_SPLIT2DIR = {"trainval": "flickr30k_images",
                    "test2017": "test_2017_flickr30k_images",
                    "test2018": "test_2018_flickr30k_images"}

_IMG_EXT = (".jpg", ".jpeg", ".png", ".bmp")


def _iter_dir(image_dir: str) -> Iterator[Item]:
    for fn in sorted(os.listdir(image_dir)):
        if fn.lower().endswith(_IMG_EXT):
            yield os.path.splitext(fn)[0], os.path.join(image_dir, fn), None


def _load_instances(ann_path: str) -> Dict[int, List[List[float]]]:
    """COCO instances json → {image_id: [xyxy boxes]} (what the reference
    pulls out of pycocotools in coco_gt.py:22-38 / refer.py)."""
    with open(ann_path) as f:
        inst = json.load(f)
    id2dets: Dict[int, List[List[float]]] = {}
    for ann in inst["annotations"]:
        x, y, w, h = ann["bbox"][:4]
        id2dets.setdefault(int(ann["image_id"]), []).append(
            [x, y, x + w, y + h])
    return id2dets


def iter_coco(root: str, split: str = "valid",
              gt: bool = False) -> Iterator[Item]:
    """COCO proposal (coco_proposal.py) or GT-box (coco_gt.py) listing:
    images/<split-dir>/*.jpg; GT boxes from instances_<split-dir>.json."""
    sdir = COCO_SPLIT2DIR[split]
    img_dir = os.path.join(root, "images", sdir)
    if not gt:
        yield from _iter_dir(img_dir)
        return
    id2dets = _load_instances(
        os.path.join(root, "annotations", f"instances_{sdir}.json"))
    for image_id, dets in sorted(id2dets.items()):
        name = f"COCO_{sdir}_{str(image_id).zfill(12)}"   # coco_gt.py:55
        yield (name, os.path.join(img_dir, f"{name}.jpg"),
               np.asarray(dets, np.float32))


def iter_flickr30k(root: str, split: str = "trainval") -> Iterator[Item]:
    """flickr30k_proposal.py: plain directory per split."""
    yield from _iter_dir(
        os.path.join(root, "flickr30k_images", FLICKR_SPLIT2DIR[split]))


def iter_vcr(root: str, split: str = "val",
             gt: bool = False) -> Iterator[Item]:
    """vcr_proposal.py / vcr_gt.py: unique img_ids from <split>.jsonl;
    GT mode reads each item's metadata_fn json (already xyxy boxes)."""
    image_dir = os.path.join(root, "vcr1images")
    seen = set()
    with open(os.path.join(root, f"{split}.jsonl")) as f:
        for line in f:
            item = json.loads(line)
            if item["img_id"] in seen:
                continue
            seen.add(item["img_id"])
            path = os.path.join(image_dir, item["img_fn"])
            boxes = None
            if gt:
                with open(os.path.join(image_dir, item["metadata_fn"])) as mf:
                    meta = json.load(mf)
                boxes = np.asarray([r[:4] for r in meta["boxes"]], np.float32)
            yield item["img_id"], path, boxes


def iter_refcocog(root: str, coco_images_dir: str, split: str = "val",
                  dataset: str = "refcocog",
                  split_by: str = "umd") -> Iterator[Item]:
    """refcocog_gt.py semantics without pycocotools/REFER: refs from
    ``<dataset>/refs(<split_by>).p`` (pickle list of ref dicts), per-image
    GT detections from ``<dataset>/instances.json``. Image filename drops
    the ref's annotation suffix (refcocog_gt.py:49-55)."""
    ddir = os.path.join(root, dataset)
    with open(os.path.join(ddir, f"refs({split_by}).p"), "rb") as f:
        refs = pickle.load(f)
    id2dets = _load_instances(os.path.join(ddir, "instances.json"))
    seen = set()
    for ref in refs:
        if ref.get("split") != split:
            continue
        img_id = int(ref["image_id"])
        if img_id in seen or img_id not in id2dets:
            continue
        seen.add(img_id)
        fn_ann = ref["file_name"]
        suffix = fn_ann.split(".")[-1]
        fname = "_".join(fn_ann.split("_")[:-1]) + "." + suffix
        yield (str(img_id), os.path.join(coco_images_dir, fname),
               np.asarray(id2dets[img_id], np.float32))


def iter_refcocog_mattnet(root: str, coco_images_dir: str,
                          split: str = "val",
                          dataset: str = "refcocog",
                          split_by: str = "umd") -> Iterator[Item]:
    """refcocog_mattnet.py semantics: same ref/image enumeration as the
    GT script, but boxes come from MAttNet's Mask-R-CNN detections file
    ``<root>/detections/refcocog_umd/res101_coco_minus_refer_notime_dets
    .json`` — a flat list of ``{image_id, box: [x,y,w,h], ...}`` dicts
    grouped per image and converted xywh → xyxy
    (refcocog_mattnet.py:19-29, 85-95)."""
    ddir = os.path.join(root, dataset)
    dets_path = os.path.join(
        root, "detections", f"{dataset}_{split_by}",
        "res101_coco_minus_refer_notime_dets.json")
    with open(dets_path) as f:
        dets = json.load(f)
    id2boxes: Dict[int, List[List[float]]] = {}
    for det in dets:
        x, y, w, h = det["box"][:4]
        id2boxes.setdefault(int(det["image_id"]), []).append(
            [x, y, x + w, y + h])
    with open(os.path.join(ddir, f"refs({split_by}).p"), "rb") as f:
        refs = pickle.load(f)
    seen = set()
    for ref in refs:
        if ref.get("split") != split:
            continue
        img_id = int(ref["image_id"])
        if img_id in seen or img_id not in id2boxes:
            continue
        seen.add(img_id)
        fn_ann = ref["file_name"]
        suffix = fn_ann.split(".")[-1]
        fname = "_".join(fn_ann.split("_")[:-1]) + "." + suffix
        yield (str(img_id), os.path.join(coco_images_dir, fname),
               np.asarray(id2boxes[img_id], np.float32))


DATASETS = {
    "coco": iter_coco,
    "flickr30k": iter_flickr30k,
    "vcr": iter_vcr,
    "refcocog": iter_refcocog,
}


def enumerate_dataset(name: str, root: str, split: str,
                      gt: bool = False,
                      coco_images_dir: Optional[str] = None
                      ) -> Iterator[Item]:
    """Uniform front door for the CLI."""
    if name == "coco":
        return iter_coco(root, split or "valid", gt=gt)
    if name == "flickr30k":
        return iter_flickr30k(root, split or "trainval")
    if name == "vcr":
        return iter_vcr(root, split or "val", gt=gt)
    if name == "refcocog":
        assert coco_images_dir, "--coco_images required for refcocog"
        if not gt:
            # the reference ships only GT-box scripts for refcocog
            # (refcocog_gt.py / refcocog_mattnet.py — both given-box);
            # silently running proposal extraction here would be
            # inconsistent with the other datasets' flag semantics
            raise ValueError(
                "refcocog has no proposal-mode script; pass gt=True "
                "(GT boxes) or use iter_refcocog_mattnet for MAttNet "
                "detections")
        return iter_refcocog(root, coco_images_dir, split or "val")
    if name == "refcocog_mattnet":
        assert coco_images_dir, "--coco_images required for refcocog_mattnet"
        return iter_refcocog_mattnet(root, coco_images_dir, split or "val")
    raise ValueError(f"unknown dataset {name!r}")
