"""Detection CLI (port of ``rep_yolo_tpu/cli/detect.py``, reference
detect.py:18-166): load weights -> fuse -> letterbox -> forward + NMS on
the card -> scale back -> save annotated images / videos and label txts.

    python -m rep_yolo_tpu_torch.cli.detect --source <image | dir | video |
        webcam index | stream URL> [--weights runs/train/exp/best]
        [--augment] [--fast int8] [--save-txt] [--device cpu]

Runs on the card unless ``--device cpu``: the fused forward's attention on
K1 / K2, NMS on K3, and with ``--fast int8`` the int8 region's kernels.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("rep-yolo-tpu-torch detect")
    p.add_argument("--weights", default=None,
                   help="checkpoint .npz of either package (its EMA weights "
                        "are used); seeded random init if unset")
    p.add_argument("--cfg", default="cfg/rep_yolo.yaml")
    p.add_argument("--source", required=True,
                   help="image file or dir, video file, webcam index or "
                        "stream URL")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--nc", type=int, default=1)
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--augment", action="store_true",
                   help="test-time augmentation: 3 scales x flips, merged "
                        "before NMS (reference detect.py:90, "
                        "models/yolo.py:569-585)")
    p.add_argument("--no-fuse", action="store_true",
                   help="run the train-mode multi-branch forward")
    p.add_argument("--fast", default=None, choices=["int8"],
                   help="serving fast path: 'int8' calibrates on the first "
                        "frame and runs the backbone, neck and head as the "
                        "int8 region on the int8 kernels, the attention "
                        "blocks in float (the JAX package's --fast int8); "
                        "ignored with --no-fuse")
    p.add_argument("--project", default="runs/detect")
    p.add_argument("--name", default="exp")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_model_and_vars(args):
    """The model ``args`` asks for (``--cfg``, ``--nc``, ``--weights``,
    ``--no-fuse``, ``--device``), on its device: a checkpoint's EMA weights
    (``train.checkpoint``, either package's ``.npz``), else the seeded init
    (seed 0); fused unless ``--no-fuse``. The port's model holds its
    weights, so this returns the ``RepYOLO`` alone (the JAX function
    returns (model, variables))."""
    from rep_yolo_tpu_torch.device import resolve_device
    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.train.checkpoint import read_checkpoint

    dev = resolve_device(getattr(args, "device", None))
    model = RepYOLO.from_config(args.cfg, nc=args.nc, device=dev)
    if args.weights:
        model.load_state(read_checkpoint(args.weights)["ema"])
    else:
        model.init(torch.Generator().manual_seed(0))
    return model if args.no_fuse else model.fuse()


def fit_canvas(img0: np.ndarray, size: int):
    """A BGR frame -> (RGB uint8 (size, size, 3) canvas holding the frame
    resized by cv2 to fit at its top left, 114 elsewhere; (h, w) of the
    content; the resize ratio r0), as the JAX CLI prepares a frame."""
    import cv2

    rgb = cv2.cvtColor(img0, cv2.COLOR_BGR2RGB)
    h0, w0 = rgb.shape[:2]
    r0 = size / max(h0, w0)
    rs = cv2.resize(rgb, (int(w0 * r0), int(h0 * r0))) if r0 != 1 else rgb
    h, w = rs.shape[:2]
    canvas = np.full((size, size, 3), 114, np.uint8)
    canvas[:h, :w] = rs
    return canvas, (h, w), r0


def main(argv=None):
    args = parse_args(argv)
    import cv2

    from rep_yolo_tpu_torch.data.letterbox import letterbox_batch
    from rep_yolo_tpu_torch.device import resolve_device
    from rep_yolo_tpu_torch.ops.nms import (detections_to_numpy,
                                            non_max_suppression)
    from rep_yolo_tpu_torch.ops.quant import enable_int8_fast_path
    from rep_yolo_tpu_torch.utils.general import (check_img_size,
                                                  increment_path)

    out_dir = increment_path(Path(args.project) / args.name)
    out_dir.mkdir(parents=True, exist_ok=True)
    size = check_img_size(args.img_size, 32)
    dev = resolve_device(args.device)
    if dev.type == "cuda":      # full float32 convs, as serve.build_engine
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True

    model = load_model_and_vars(args)
    predict = model.predict_tta if args.augment else model.predict

    def run(canvas, hw):
        imgs, ratio, pad = letterbox_batch(canvas, hw, size)
        det = non_max_suppression(predict(imgs), args.conf_thres,
                                  args.iou_thres, max_nms=1024,
                                  nc=model.cfg.nc)
        return det, ratio, pad

    t_sum = 0.0
    n_frames = 0
    writer = None
    with torch.inference_mode():
        for f, img0, fps in _frame_source(args.source):
            is_video = fps is not None
            n_frames += 1
            h0, w0 = img0.shape[:2]
            canvas, (h, w), r0 = fit_canvas(img0, size)
            x = torch.from_numpy(canvas[None]).to(dev)
            hw = torch.tensor([[h, w]], dtype=torch.float32, device=dev)
            if args.fast == "int8" and n_frames == 1 and not args.no_fuse:
                # calibrate the activation scales on the first real frame
                enable_int8_fast_path(model, letterbox_batch(x, hw, size)[0])

            t0 = time.perf_counter()
            det, ratio, pad = run(x, hw)
            d = detections_to_numpy(det)[0]
            t_sum += time.perf_counter() - t0
            r = float(ratio[0])
            pw, ph = pad[0].tolist()
            if d.shape[0]:
                d[:, [0, 2]] = ((d[:, [0, 2]] - pw) / r / r0).clip(0, w0)
                d[:, [1, 3]] = ((d[:, [1, 3]] - ph) / r / r0).clip(0, h0)

            name = Path(f).name
            print(f"{name}: {d.shape[0]} detections")
            for row in d:
                x1, y1, x2, y2, conf, cls = row
                cv2.rectangle(img0, (int(x1), int(y1)), (int(x2), int(y2)),
                              (0, 255, 0), 2)
                cv2.putText(img0, f"{int(cls)} {conf:.2f}",
                            (int(x1), int(y1) - 4), cv2.FONT_HERSHEY_SIMPLEX,
                            0.6, (0, 255, 0), 1)
            if is_video:
                if writer is None:
                    writer = cv2.VideoWriter(
                        str(out_dir / (Path(f).stem + ".mp4")),
                        cv2.VideoWriter_fourcc(*"mp4v"), fps,
                        (img0.shape[1], img0.shape[0]))
                writer.write(img0)
            else:
                cv2.imwrite(str(out_dir / name), img0)
            if args.save_txt:
                with open(out_dir / (Path(f).stem + ".txt"), "a") as fh:
                    for row in d:
                        x1, y1, x2, y2, conf, cls = row
                        xc = (x1 + x2) / 2 / w0
                        yc = (y1 + y2) / 2 / h0
                        bw = (x2 - x1) / w0
                        bh = (y2 - y1) / h0
                        fh.write(f"{int(cls)} {xc:.6f} {yc:.6f} "
                                 f"{bw:.6f} {bh:.6f} {conf:.4f}\n")
    if writer is not None:
        writer.release()
    n = max(n_frames, 1)
    print(f"done: {n_frames} frames, {1000 * t_sum / n:.1f} ms/frame "
          f"(incl. first-compile). results -> {out_dir}")
    return out_dir


VID_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v"}


def _frame_source(source: str):
    """Yield (name, BGR frame, fps or None) from an image file / dir, a
    video file, a webcam index, or a stream URL (reference LoadImages /
    LoadWebcam / LoadStreams, utils/datasets.py:128-351)."""
    import cv2

    from rep_yolo_tpu_torch.data.datasets import discover_images

    def video_frames(cap, name):
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            # constant name per source: the writer derives its filename
            # and the label txt appends per frame
            yield name, frame, fps
        cap.release()

    if source.isdigit():                      # webcam index
        yield from video_frames(cv2.VideoCapture(int(source)),
                                f"webcam{source}")
        return
    if source.startswith(("rtsp://", "http://", "https://")):
        yield from video_frames(cv2.VideoCapture(source), "stream")
        return
    src = Path(source)
    if src.is_file() and src.suffix.lower() in VID_EXTS:
        yield from video_frames(cv2.VideoCapture(str(src)), src.stem)
        return
    files = [str(src)] if src.is_file() else discover_images(src)
    for f in files:
        img = cv2.imread(f)
        assert img is not None, f"cannot read {f}"
        yield f, img, None


if __name__ == "__main__":
    main()
