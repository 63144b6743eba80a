"""NExT-QA video feature extraction (the ``app_mot_{mode}.h5`` producer).

Counterpart of ``vqacl_tpu/vision/video.py``. The reference consumes
these files (nextqa/nextqa_data.py reads ``feat[16, 4096]`` =
[appearance 2048 ‖ motion 2048] and uses the motion half); upstream
extracted them with an ImageNet ResNet-152 (appearance) and a Kinetics
3D-ResNeXt-101 (motion) at 16 uniformly sampled clips per video. Here:

- **appearance half**: the ResNet-101 of ``vision/resnet.py`` (the
  detector's backbone) over 16 uniformly sampled frames, the global mean
  of res5 → 2048-d;
- **motion half**, two sources:
  1. the Kinetics 3D-ResNeXt-101 (``vision/resnext3d.py``) over 16
     consecutive-frame clips around each sample point, when
     ``motion_params`` are given;
  2. otherwise a TSN-style RGB-difference stream (Wang et al., ECCV
     2016) through the same 2D backbone.

Frame sources: a directory of frame images (PIL), a video file (cv2), or
a ``.npy`` [T,H,W,3] uint8 array (neither library needed). The networks
run on the device their weights are on.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

N_CLIPS = 16
FEAT_DIM = 2048
SIDE = 224          # square input per frame (upstream uses 224 crops)

_IMG_EXT = (".jpg", ".jpeg", ".png", ".bmp")


def sample_indices(total: int, n: int = N_CLIPS) -> np.ndarray:
    """n uniformly spaced frame indices over [0, total) (clip centers —
    the NExT-QA sampling scheme)."""
    if total <= 0:
        return np.zeros((n,), np.int64)
    return np.minimum((np.arange(n) + 0.5) * total / n,
                      total - 1).astype(np.int64)


def load_frames(source: str, n: int = N_CLIPS) -> np.ndarray:
    """→ [n, H, W, 3] uint8 BGR frames from a frame dir / video / .npy."""
    if os.path.isdir(source):
        files = sorted(f for f in os.listdir(source)
                       if f.lower().endswith(_IMG_EXT))
        if not files:
            raise ValueError(f"no frames in {source}")
        idx = sample_indices(len(files), n)
        from PIL import Image
        out = []
        for i in idx:
            rgb = np.asarray(Image.open(
                os.path.join(source, files[i])).convert("RGB"))
            out.append(rgb[:, :, ::-1])                       # → BGR
        return np.stack(out)
    if source.endswith(".npy"):
        arr = np.load(source)
        idx = sample_indices(arr.shape[0], n)
        return np.ascontiguousarray(arr[idx])
    import cv2
    cap = cv2.VideoCapture(source)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    idx = set(sample_indices(total, n).tolist())
    frames, got = [], {}
    t = 0
    while True:
        ok, frame = cap.read()                                # BGR
        if not ok:
            break
        if t in idx:
            got[t] = frame
        t += 1
    cap.release()
    if not got:
        raise ValueError(f"no decodable frames in {source}")
    keys = sorted(got)
    for i in sample_indices(total, n):
        # nearest decoded frame (robust to unreadable tails)
        frames.append(got[min(keys, key=lambda k: abs(k - int(i)))])
    return np.stack(frames)


def load_clips(source: str, n_clips: int = N_CLIPS,
               clip_len: int = 16) -> np.ndarray:
    """→ [n_clips, clip_len, H, W, 3] uint8 BGR: ``clip_len``
    CONSECUTIVE frames centered on each of ``n_clips`` uniform sample
    points (boundary-clamped) — the 3D-backbone input geometry
    (HCRN/NExT-QA extraction: 16 clips x 16 frames)."""
    if os.path.isdir(source):
        files = sorted(f for f in os.listdir(source)
                       if f.lower().endswith(_IMG_EXT))
        if not files:
            raise ValueError(f"no frames in {source}")
        total = len(files)

        def get(i: int) -> np.ndarray:
            from PIL import Image
            rgb = np.asarray(Image.open(
                os.path.join(source, files[i])).convert("RGB"))
            return rgb[:, :, ::-1]
    elif source.endswith(".npy"):
        arr = np.load(source)
        total = arr.shape[0]

        def get(i: int) -> np.ndarray:
            return arr[i]
    else:
        # video file: one sequential pass, keep only needed frames
        import cv2
        cap = cv2.VideoCapture(source)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        centers = sample_indices(total, n_clips)
        need = set()
        for c in centers:
            need.update(int(np.clip(c - clip_len // 2 + j, 0, total - 1))
                        for j in range(clip_len))
        got = {}
        t = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if t in need:
                got[t] = frame
            t += 1
        cap.release()
        if not got:
            raise ValueError(f"no decodable frames in {source}")
        keys = sorted(got)

        def get(i: int) -> np.ndarray:
            return got[min(keys, key=lambda k: abs(k - i))]

    centers = sample_indices(total, n_clips)
    clips = []
    for c in centers:
        idx = np.clip(c - clip_len // 2 + np.arange(clip_len), 0, total - 1)
        clips.append(np.stack([get(int(i)) for i in idx]))
    return np.stack(clips)


def _resize_square(frames: np.ndarray, side: int = SIDE) -> np.ndarray:
    """[T,H,W,3] uint8 → [T,side,side,3] f32 (PIL bilinear). Frames that
    are already side × side come back as f32 unchanged, without PIL
    (PIL's resize to the same size is a copy)."""
    if frames.shape[1:3] == (side, side):
        return np.asarray(frames, np.float32)
    from PIL import Image
    out = np.empty((frames.shape[0], side, side, 3), np.float32)
    for i, f in enumerate(frames):
        out[i] = np.asarray(Image.fromarray(
            f[:, :, ::-1]).resize((side, side), Image.BILINEAR),
            np.float32)[:, :, ::-1]
    return out


def make_frame_feature_fn(params):
    """[T,side,side,3] BGR (f32, unnormalized, numpy) → [T,2048] numpy
    pooled res5 features of the ResNet-101, on the weights' device."""
    from vqacl_tpu_torch.vision.frcnn import PIXEL_MEAN_BGR
    from vqacl_tpu_torch.vision.resnet import backbone_c4, res5_head

    dev = params["backbone"]["stem"]["w"].device
    mean = torch.from_numpy(PIXEL_MEAN_BGR).to(dev)

    @torch.inference_mode()
    def fn(frames):
        x = torch.as_tensor(np.asarray(frames, np.float32), device=dev)
        x = (x - mean).permute(0, 3, 1, 2).contiguous()
        c4 = backbone_c4(params["backbone"], x)               # [T,1024,h,w]
        r5 = res5_head(params["backbone"], c4)                # [T,2048,..]
        return r5.mean(dim=(2, 3)).cpu().numpy()              # [T,2048]

    return fn


def make_motion_feature_fn(motion_params, stages=None):
    """[n_clips, clip_len, S, S, 3] preprocessed RGB clips (numpy) →
    [n_clips, 2048] numpy 3D-ResNeXt features, on the weights' device."""
    from vqacl_tpu_torch.vision.resnext3d import resnext3d_features

    dev = motion_params["stem"]["w"].device

    @torch.inference_mode()
    def fn(clips):
        x = torch.as_tensor(np.asarray(clips, np.float32), device=dev)
        x = x.permute(0, 4, 1, 2, 3).contiguous()            # NCDHW
        return resnext3d_features(motion_params, x, stages).cpu().numpy()

    return fn


def motion_clip_features(motion_fn, clips_bgr: np.ndarray,
                         side: int = 112) -> np.ndarray:
    """[n_clips, clip_len, H, W, 3] uint8 BGR → [n_clips, 2048] via the
    3D backbone (resize to its 112² input, BGR→RGB, Kinetics-mean
    preprocess — vision/resnext3d.py geometry)."""
    from vqacl_tpu_torch.vision.resnext3d import preprocess_clip
    sq = np.stack([_resize_square(c, side) for c in clips_bgr])
    rgb = sq[..., ::-1]
    return np.asarray(motion_fn(preprocess_clip(rgb)), np.float32)


def extract_clip_features(frame_fn, frames: np.ndarray,
                          side: int = SIDE) -> np.ndarray:
    """[T,H,W,3] uint8 BGR → [T, 4096] = [appearance ‖ RGB-diff motion].

    The motion stream wraps around at the clip boundary (frame_0 diffs
    against frame_{T-1}) so every sample point has a difference signal.
    """
    sq = _resize_square(frames, side)                         # [T,S,S,3] f32
    app = np.asarray(frame_fn(sq), np.float32)                # [T,2048]
    diff = sq - np.roll(sq, 1, axis=0)
    # re-center diffs into the backbone's input range (means cancel in
    # the subtraction, so add the pixel mean back)
    from vqacl_tpu_torch.vision.frcnn import PIXEL_MEAN_BGR
    mot = np.asarray(frame_fn(diff + PIXEL_MEAN_BGR), np.float32)
    return np.concatenate([app, mot], axis=1)                 # [T,4096]


def write_app_mot_h5(path: str, table: Dict[str, np.ndarray]) -> None:
    """Reference schema: ``ids`` [N] bytes, ``feat`` [N,16,4096] f32
    (consumption site: nextqa/data.py VideoFeatureStore)."""
    import h5py

    vids = sorted(table)
    feat = np.stack([np.asarray(table[v], np.float32) for v in vids])
    assert feat.shape[1:] == (N_CLIPS, 2 * FEAT_DIM), feat.shape
    with h5py.File(path, "w") as fp:
        fp.create_dataset("ids", data=np.asarray(
            [v.encode() for v in vids]))
        fp.create_dataset("feat", data=feat)


def extract_videos(params, sources: Dict[str, str],
                   out_h5: Optional[str] = None,
                   side: int = SIDE,
                   verbose: bool = False,
                   motion_params=None,
                   motion_stages=None,
                   motion_side: int = 112) -> Dict[str, np.ndarray]:
    """{video_id: frame source} → {video_id: feat[16,4096]}, optionally
    written to ``out_h5`` in the app_mot schema. With ``motion_params``
    (a vision/resnext3d.py tree, e.g. converted from
    ``resnext-101-kinetics.pth``) the motion half is the real Kinetics
    3D backbone over consecutive-frame clips; otherwise the RGB-diff
    fallback shares the 2D backbone."""
    frame_fn = make_frame_feature_fn(params)
    motion_fn = (make_motion_feature_fn(motion_params, motion_stages)
                 if motion_params is not None else None)
    table: Dict[str, np.ndarray] = {}
    for vid, src in sorted(sources.items()):
        frames = load_frames(src)
        if motion_fn is None:
            table[vid] = extract_clip_features(frame_fn, frames, side=side)
        else:
            sq = _resize_square(frames, side)
            app = np.asarray(frame_fn(sq), np.float32)        # [T,2048]
            mot = motion_clip_features(motion_fn, load_clips(src),
                                       side=motion_side)      # [T,2048]
            table[vid] = np.concatenate([app, mot], axis=1)
        if verbose:
            print(f"  {vid}: {frames.shape} -> {table[vid].shape}",
                  flush=True)
    if out_h5 is not None:
        write_app_mot_h5(out_h5, table)
    return table


def enumerate_video_sources(root: str) -> Dict[str, str]:
    """A directory of per-video frame dirs / video files / .npy clips →
    {video_id: source path}."""
    out: Dict[str, str] = {}
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if os.path.isdir(p) or name.endswith(
                (".npy", ".mp4", ".avi", ".mkv", ".webm")):
            out[os.path.splitext(name)[0]] = p
    return out
