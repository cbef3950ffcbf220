"""Video frame extraction, Hand100M layer A (counterpart of
``simhand_tpu/mining/extract_frames.py``).

Equivalent of the reference extractors
(Hand100M/ego4d_process.py, 100doh_process.py): samples 1 frame per
``stride`` (default 30 ~ 1 fps) from each video in a manifest into
``<out_dir>/<video_id>/frame_%06d.jpg``. Missing/corrupt videos are
skipped and reported, not fatal. Host only; ``cv2`` is imported inside
``extract_video``.

Usage:
  python -m simhand_tpu_torch.mining.extract_frames \
      --manifest ego4d_name_list.txt --video_dir /videos --out_dir /frames
"""
from __future__ import annotations

import argparse
import os


def extract_video(video_path: str, out_dir: str, stride: int = 30) -> int:
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return 0
    os.makedirs(out_dir, exist_ok=True)
    n_saved = 0
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % stride == 0:
            cv2.imwrite(os.path.join(out_dir, f"frame_{idx:06d}.jpg"), frame)
            n_saved += 1
        idx += 1
    cap.release()
    return n_saved


def manifest_names(path: str, ext: str) -> list[str]:
    """The video file names of a manifest. Both documented manifests are
    multi-column: the Ego4D list has a header row and the name in column 1
    ("<num> <id>.mp4 <size> ...", ego4d_process.py:44-45), the 100DOH list
    has the bare id in column 0 (100doh_process.py:29-30). Takes the first
    token ending in ``ext``, else column 0 + ``ext``; single-column
    id-per-line files work too."""
    with open(path) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    has_ext = [any(t.endswith(ext) for t in r) for r in rows]
    if rows and not has_ext[0] and any(has_ext[1:]):
        rows = rows[1:]  # Ego4D-style header row

    def pick(parts):
        for tok in parts:
            if tok.endswith(ext):
                return tok
        return parts[0] + ext

    return [pick(parts) for parts in rows]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", required=True,
                   help="video list: Ego4D layout (header + '<n> <id>.mp4 "
                        "...'), 100DOH layout ('<id> ...'), or one bare "
                        "id per line")
    p.add_argument("--video_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--stride", type=int, default=30)
    p.add_argument("--ext", default=".mp4")
    args = p.parse_args(argv)

    total, skipped = 0, 0
    for name in manifest_names(args.manifest, args.ext):
        path = os.path.join(args.video_dir, name)
        if not os.path.exists(path):
            skipped += 1
            continue
        total += extract_video(path, os.path.join(args.out_dir, os.path.splitext(name)[0]),
                               args.stride)
    print(f"extracted {total} frames; {skipped} videos missing")


if __name__ == "__main__":
    main()
