"""Real-time hand capture demo: camera -> detnet -> One-Euro smoothing ->
shape fit (ShapeNet or PSO) -> analytic IK -> MANO mesh (the JAX
package's ``finetune/demo.py``).

Reference: minimal-hand/demo.py:69-139 and demo_dl.py. The reference
renders the MANO mesh in a separate open3d viewport; here the mesh side
panel is drawn by finetune/render.py — a software rasterizer with
vertex-normal Lambertian shading and an orbitable camera (``--spin``
rotates the view per frame like dragging the o3d camera; ``--panel
wireframe`` keeps the line render).

The work on a decoded frame is ``track_frame``, which needs no cv2: the
detnet forward and MANO on the card (unless ``--device cpu``), the
smoothing, AIK and PSO's particle update on the host. ``main`` wraps it in
cv2's decode and drawing.

  python -m simhand_tpu_torch.finetune.demo --video input.mp4 \\
      --pretrain detnet.pth --mano mano/models/MANO_RIGHT.pkl \\
      --out annotated.mp4
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable

import numpy as np
import torch

from simhand_tpu_torch.finetune.lm_fit import ref_bones_from_joints
from simhand_tpu_torch.finetune.mano import ManoModel
from simhand_tpu_torch.finetune.maps import SNAP_PARENT
from simhand_tpu_torch.finetune.recon import reconstruct
from simhand_tpu_torch.finetune.shape_net import ShapeNet
from simhand_tpu_torch.finetune.smoother import OneEuroFilter

# freihand/snap-order skeleton (detnet output order)
BONES = [(i, SNAP_PARENT[i]) for i in range(1, 21)]


def draw_skeleton(frame, uv, color=(0, 255, 0)):
    import cv2

    for a, b in BONES:
        cv2.line(frame, tuple(uv[a].astype(int)), tuple(uv[b].astype(int)),
                 color, 2)
    for p in uv:
        cv2.circle(frame, tuple(p.astype(int)), 3, (0, 0, 255), -1)
    return frame


def render_mesh_panel(verts: np.ndarray, faces: np.ndarray | None,
                      size: int) -> np.ndarray:
    """Orthographic cv2 wireframe of the MANO mesh (the open3d-viewport
    substitute): xy projection, centered and scaled into a size x size
    panel. Falls back to a vertex scatter when faces are absent."""
    import cv2

    panel = np.zeros((size, size, 3), np.uint8)
    v = np.asarray(verts, np.float64)
    xy = v[:, :2] - v[:, :2].mean(0)
    scale = 0.42 * size / max(np.abs(xy).max(), 1e-9)
    pts = (xy * scale + size / 2.0).astype(np.int32)
    pts[:, 1] = size - 1 - pts[:, 1]  # y up
    if faces is not None:
        polys = pts[np.asarray(faces, np.int32)]          # (F, 3, 2)
        cv2.polylines(panel, list(polys), True, (180, 180, 180), 1,
                      cv2.LINE_AA)
    else:
        for p in pts:
            cv2.circle(panel, tuple(p), 1, (180, 180, 180), -1)
    return panel


@dataclasses.dataclass
class DemoState:
    """What persists from frame to frame. ``apply`` maps images (N, 128,
    128, 3) float32 to the detnet's outputs (``xyz``, ``uv``); without
    ``mano`` only the joints are tracked; with ``shape_net`` the shape is
    regressed every frame (demo_dl.py), else PSO fits it on the first."""

    apply: Callable
    mano: ManoModel | None = None
    shape_net: ShapeNet | None = None
    smoother: OneEuroFilter = dataclasses.field(
        default_factory=lambda: OneEuroFilter(mincutoff=1.0, beta=0.0))
    # demo_dl.py smooths the regressed shape with its own filter
    # (shape_fliter = OneEuroFilter(4.0, 0.0))
    shape_smoother: OneEuroFilter = dataclasses.field(
        default_factory=lambda: OneEuroFilter(mincutoff=4.0, beta=0.0))
    beta: np.ndarray | None = None


def regress_shape(state: DemoState, xyz: np.ndarray) -> np.ndarray:
    """The DL route (demo_dl.py): bone lengths of the smoothed prediction ->
    ShapeNet beta, One-Euro smoothed."""
    bones = torch.as_tensor(ref_bones_from_joints(xyz[None]), dtype=torch.float32)
    with torch.no_grad():
        beta = state.shape_net(bones.to(state.mano.device))
    return state.shape_smoother.process(beta.cpu().numpy()[0])


def track_frame(state: DemoState, inp: np.ndarray):
    """One decoded frame (128, 128, 3) float32 in [-0.5, 0.5] (RGB) ->
    (xyz (21, 3) smoothed, uv (21, 2) as (row, col) on the 32x32 map, verts
    (778, 3) or None, beta (10,) or None). Updates ``state``."""
    preds = state.apply(torch.from_numpy(np.ascontiguousarray(inp[None], np.float32)))
    xyz = state.smoother.process(preds["xyz"][0].float().cpu().numpy())
    uv = preds["uv"][0].cpu().numpy()
    verts = None
    if state.mano is not None:
        if state.shape_net is not None:
            state.beta = regress_shape(state, xyz)
        # else: beta fitted once on the first frame (reference: demo.py
        # fits the shape once, then tracks pose per frame)
        verts, _, _, state.beta = reconstruct(state.mano, xyz, beta=state.beta)
    return xyz, uv, verts, state.beta


def load_detnet(args, dev) -> Callable:
    """The detnet's forward from ``--artifact`` (the port's serving
    artifact), or a ``DetNet(resnet_size=--backbone)`` with ``--pretrain``'s
    weights or flax's initialisers from seed 0."""
    if args.artifact:
        # deployed path: the artifact carries the weights, no model
        # construction, no checkpoint
        from simhand_tpu_torch.serving.export import load_artifact

        apply, _meta = load_artifact(args.artifact, dev)
        return apply
    from simhand_tpu_torch.finetune.detnet import DetNet
    from simhand_tpu_torch.finetune.train import init_detnet
    from simhand_tpu_torch.serving.export import build_detnet_forward

    model = DetNet(resnet_size=args.backbone)
    init_detnet(model, 0)
    if args.pretrain:
        from simhand_tpu_torch.convert import load_detnet_state_dict

        load_detnet_state_dict(model, torch.load(args.pretrain, map_location="cpu",
                                                 weights_only=True))
    forward = build_detnet_forward(model.to(dev))

    def apply(images):
        with torch.inference_mode():
            return forward(images.to(dev))

    return apply


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video", default=None, help="video path (default: webcam 0)")
    p.add_argument("--mano", default=None, help="MANO_RIGHT.pkl path")
    p.add_argument("--artifact", default=None,
                   help="serve from the port's serving artifact "
                        "(simhand-torch-export-serving --surface detnet); "
                        "replaces --pretrain/--backbone model setup")
    p.add_argument("--pretrain", default=None,
                   help="detnet .pth (the reference's keys) to load")
    p.add_argument("--backbone", default="50")
    p.add_argument("--shape_net", default=None,
                   help="trained ShapeNet (the port's .pt or a flax msgpack): "
                        "regress the MANO shape per frame with One-Euro "
                        "smoothing (reference demo_dl.py:31-36,~100) instead "
                        "of the one-shot PSO fit")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--out", default=None, help="write annotated video here")
    p.add_argument("--panel", default="shaded",
                   choices=["shaded", "wireframe"],
                   help="mesh viewport style (shaded = lit 3-D render, "
                        "the open3d-viewport equivalent)")
    p.add_argument("--spin", type=float, default=0.0,
                   help="orbit the mesh view by this many degrees per "
                        "frame (camera rotation, like o3d mouse orbit)")
    p.add_argument("--elevation", type=float, default=15.0,
                   help="camera elevation for the shaded panel (deg)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)

    import cv2

    from simhand_tpu_torch.device import resolve_device
    from simhand_tpu_torch.finetune.render import render_mesh_shaded
    from simhand_tpu_torch.finetune.shape_net import load_shape_net

    dev = resolve_device(device or args.device)
    state = DemoState(apply=load_detnet(args, dev))
    if args.mano:
        state.mano = ManoModel(args.mano, device=dev)
    if args.shape_net:
        state.shape_net = load_shape_net(args.shape_net, dev)

    cap = cv2.VideoCapture(args.video if args.video else 0)
    writer = None
    n = 0
    while cap.isOpened():
        ok, frame = cap.read()
        if not ok or (args.max_frames and n >= args.max_frames):
            break
        n += 1
        h, w = frame.shape[:2]
        side = min(h, w)
        # center square crop; model input is RGB (training images are
        # RGB — the reference demo flips cv2's BGR channels, demo.py:71)
        y0, x0 = (h - side) // 2, (w - side) // 2
        crop = frame[y0 : y0 + side, x0 : x0 + side]
        rgb = cv2.cvtColor(crop, cv2.COLOR_BGR2RGB)
        inp = cv2.resize(rgb, (128, 128)).astype(np.float32) / 255.0 - 0.5
        _, uv, verts, _ = track_frame(state, inp)
        uv = uv[:, ::-1] * (side / 32.0)  # (col, row)

        frame_out = draw_skeleton(crop, uv)
        if verts is not None:
            if args.panel == "shaded" and state.mano.faces is not None:
                panel = render_mesh_shaded(
                    verts, state.mano.faces, side,
                    azimuth_deg=args.spin * n,
                    elevation_deg=args.elevation,
                )
            else:
                panel = render_mesh_panel(verts, state.mano.faces, side)
            frame_out = np.concatenate([frame_out, panel], axis=1)
        if args.out:
            if writer is None:
                writer = cv2.VideoWriter(
                    args.out, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                    (frame_out.shape[1], frame_out.shape[0]),
                )
            writer.write(frame_out)
    cap.release()
    if writer is not None:
        writer.release()
    print(f"processed {n} frames")


if __name__ == "__main__":
    main()
