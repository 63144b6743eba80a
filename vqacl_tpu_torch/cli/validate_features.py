"""Validate extracted region features against a reference h5.

Counterpart of ``vqacl_tpu/cli/validate_features.py``: after converting
the VG detector weights, run the extraction pipeline over sample COCO
images and compare with the shipped ``*_obj36.h5`` features — per image,
greedy box IoU matching and the feature cosine over matched boxes.

    python -m vqacl_tpu_torch.cli.validate_features \
        --images val2014_sample/ --h5 val2014_obj36.h5 \
        --weights frcnn_vg.npz [--topk 50] [--platform cpu]

Needs PIL (the image decoder) and h5py (the reference file).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def match_and_score(ours: dict, ref_feats: np.ndarray, ref_boxes: np.ndarray
                    ) -> dict:
    """Greedy IoU matching of our 36 boxes to the reference 36; cosine
    similarity of features over matches with IoU ≥ 0.5."""
    from vqacl_tpu_torch.ops.nms import box_iou

    iou = box_iou(torch.as_tensor(np.asarray(ours["boxes"], np.float32)),
                  torch.as_tensor(np.asarray(ref_boxes, np.float32))).numpy()
    n = iou.shape[0]
    matched, used = [], set()
    for i in np.argsort(-iou.max(axis=1)):
        j = int(np.argmax([iou[i, j] if j not in used else -1
                           for j in range(n)]))
        if iou[i, j] >= 0.5:
            matched.append((i, j, iou[i, j]))
            used.add(j)
    cosines = []
    for i, j, _ in matched:
        a, b = ours["features"][i], ref_feats[j]
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        if denom > 0:
            cosines.append(float(a @ b / denom))
    return {
        "n_matched": len(matched),
        "mean_iou": float(np.mean([m[2] for m in matched])) if matched else 0,
        "mean_feature_cosine": float(np.mean(cosines)) if cosines else 0,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--images", required=True)
    p.add_argument("--h5", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--platform", default="auto",
                   choices=["auto", "cuda", "cpu"],
                   help="the device: auto and cuda = the CUDA card (an "
                        "error without one), cpu = the plain PyTorch path "
                        "on the host")
    args = p.parse_args(argv)

    import h5py

    from vqacl_tpu_torch.cli.args import platform_device
    from vqacl_tpu_torch.cli.extract_features import iter_images
    from vqacl_tpu_torch.vision import frcnn
    from vqacl_tpu_torch.vision.convert_weights import load_npz_params

    params = load_npz_params(args.weights, platform_device(args.platform))
    scores = []
    with h5py.File(args.h5, "r") as ref:
        for i, (img_id, bgr) in enumerate(iter_images(args.images)):
            if i >= args.topk:
                break
            if img_id not in ref:
                continue
            rec = frcnn.extract_image(params, bgr)
            g = ref[img_id]
            s = match_and_score(rec, np.asarray(g["features"]),
                                np.asarray(g["boxes"]))
            scores.append(s)
            print(f"{img_id}: matched {s['n_matched']}/36 "
                  f"iou {s['mean_iou']:.3f} cos {s['mean_feature_cosine']:.3f}")
    if scores:
        print(f"\nOVERALL over {len(scores)} images: "
              f"matched {np.mean([s['n_matched'] for s in scores]):.1f}/36, "
              f"iou {np.mean([s['mean_iou'] for s in scores]):.3f}, "
              f"cosine {np.mean([s['mean_feature_cosine'] for s in scores]):.3f}")


if __name__ == "__main__":
    main(sys.argv[1:])
