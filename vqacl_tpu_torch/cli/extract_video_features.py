"""NExT-QA video feature extraction entry point.

Counterpart of ``vqacl_tpu/cli/extract_video_features.py``. Produces
``vid_feat/app_mot_{mode}.h5`` (the file the reference's
nextqa/nextqa_data.py reads) from a directory of videos, frame
directories or ``.npy`` [T,H,W,3] clips with ``vision/video.py``:
appearance = pooled res5 of the ResNet-101 per sampled frame; motion =
the Kinetics 3D-ResNeXt-101 (``vision/resnext3d.py``) when
``--motion_weights`` names the published ``resnext-101-kinetics.pth`` (or
an npz of the converted tree), else the RGB-difference stream through
the 2D backbone.

    python -m vqacl_tpu_torch.cli.extract_video_features \
        --videos /path/to/clips --out vid_feat/app_mot_train.h5 \
        --weights frcnn_vg.npz --motion_weights resnext-101-kinetics.pth

``--platform auto`` (the default) runs on the CUDA card and raises
without one; ``--platform cpu`` runs the plain path on the host. The h5
writer needs h5py; ``vision.video.extract_videos`` without ``out_h5``
returns the table instead.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--videos", required=True,
                   help="directory of per-video frame dirs, video files, "
                        "or .npy [T,H,W,3] clips")
    p.add_argument("--out", required=True, help="output app_mot h5 path")
    p.add_argument("--weights", default=None,
                   help="npz of converted backbone weights (random if "
                        "unset — validation runs only)")
    p.add_argument("--side", type=int, default=224,
                   help="square frame resolution fed to the backbone")
    p.add_argument("--motion_weights", default=None,
                   help="Kinetics 3D-ResNeXt-101 weights for the motion "
                        "half: the published resnext-101-kinetics.pth or "
                        "an npz of the converted tree (RGB-diff "
                        "fallback if unset)")
    p.add_argument("--motion_side", type=int, default=112,
                   help="square clip resolution fed to the 3D backbone")
    p.add_argument("--platform", default="auto",
                   choices=["auto", "cuda", "cpu"],
                   help="the device: auto and cuda = the CUDA card (an "
                        "error without one), cpu = the plain PyTorch path "
                        "on the host")
    args = p.parse_args(argv)

    from vqacl_tpu_torch.cli.args import platform_device
    from vqacl_tpu_torch.vision import video
    from vqacl_tpu_torch.models.convert import to_device
    from vqacl_tpu_torch.vision.convert_weights import load_npz_params

    device = platform_device(args.platform)
    if args.weights:
        params = load_npz_params(args.weights, device)
    else:
        print("WARNING: no --weights given; using random backbone weights")
        from vqacl_tpu_torch.vision import frcnn
        params = frcnn.init_frcnn(0, device)

    motion_params = None
    if args.motion_weights:
        if args.motion_weights.endswith(".npz"):
            motion_params = load_npz_params(args.motion_weights, device)
        else:
            from vqacl_tpu_torch.vision.resnext3d import load_torch_checkpoint
            motion_params = to_device(
                load_torch_checkpoint(args.motion_weights), device)

    sources = video.enumerate_video_sources(args.videos)
    print(f"extracting {len(sources)} videos -> {args.out}", flush=True)
    video.extract_videos(params, sources, out_h5=args.out,
                         side=args.side, verbose=True,
                         motion_params=motion_params,
                         motion_side=args.motion_side)
    print("done", flush=True)


if __name__ == "__main__":
    main()
