"""Export CLI (port of ``rep_yolo_tpu/cli/export.py``, the reference
export.py:19-196 counterpart): the fused deploy model's ``predict``
(optionally with NMS, the ``--include-nms`` analog of the reference's
End2End wrapper, models/experimental.py:216) is traced with
``torch.export`` and written as ``<out>.pt2`` (``torch.export.save``),
``<out>.params.npz`` and ``<out>.json``.

    python -m rep_yolo_tpu_torch.cli.export --weights runs/train/exp/best
        [--include-nms] [--bf16] [--device cpu]

The graph calls the port's custom ops ``rep_yolo_torch::axial_project`` /
``axial_attend`` (K1, K2) and, with ``--include-nms``, ``nms_keep`` (K3),
whichever device it was traced on: reload it with ``import
rep_yolo_tpu_torch`` then ``torch.export.load(path).module()``; on the
card the ops launch the kernels, on the CPU they run the plain versions.
The input is JAX's: NHWC ``(batch, img, img, 3)`` in [0, 1], float32 or,
with ``--bf16``, bfloat16 (the attention islands stay float32,
``RepYOLO.cast``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("rep-yolo-tpu-torch export")
    p.add_argument("--weights", default=None,
                   help="checkpoint .npz of either package (its EMA weights "
                        "are exported); seeded random init if unset")
    p.add_argument("--cfg", default="cfg/rep_yolo.yaml")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--nc", type=int, default=1)
    p.add_argument("--include-nms", action="store_true",
                   help="trace NMS into the exported graph (End2End)")
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--bf16", action="store_true", help="bf16 params/compute")
    p.add_argument("--out", default="runs/export/model")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu: where the graph is traced")
    return p.parse_args(argv)


class Predict(torch.nn.Module):
    """The exported function: decoded predictions (B, N, no), or with NMS
    the ``Detections`` fields (boxes, scores, classes, valid, count) as a
    tuple."""

    def __init__(self, model, include_nms: bool, conf: float, iou: float):
        super().__init__()
        self.net = model.net
        self.model, self.include_nms = model, include_nms
        self.conf, self.iou = conf, iou

    def forward(self, x):
        from rep_yolo_tpu_torch.ops.nms import non_max_suppression

        pred = self.model.predict(x)
        if not self.include_nms:
            return pred
        # "kernel": K3's custom op on either device, so the graph holds it
        return tuple(non_max_suppression(
            pred.float(), self.conf, self.iou, max_nms=1024,
            nc=self.model.cfg.nc, method="kernel"))


def deploy_params(model) -> dict[str, np.ndarray]:
    """The fused deploy parameters and buffers: under the JAX fused tree's
    flat keys (``params/l0/rbr_reparam/kernel``, HWIO) where
    ``utils/weights.jax_paths`` maps a leaf, under the port's state-dict
    key otherwise (the attention blocks' packed ``wqk`` / ``pq`` / ``pv``,
    which the JAX tree does not hold). bfloat16 leaves as 2-byte void
    arrays, as the JAX package's ``.npz`` holds them."""
    from rep_yolo_tpu_torch.utils.weights import (bf16_to_numpy, jax_paths,
                                                  state_dict_to_jax)

    net = model.net
    state = net.state_dict()
    paths = jax_paths(net)
    packed = {k for k in state if k.rsplit(".", 1)[-1] in ("wqk", "pq", "pv")}
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v

    walk(state_dict_to_jax(net, {k: v for k, v in state.items()
                                 if k not in packed}), "")
    for k in sorted(set(state) - set(paths) | packed):
        t = state[k]
        flat[k] = (bf16_to_numpy(t) if t.dtype == torch.bfloat16
                   else t.detach().cpu().numpy())
    return flat


def export_model(model, img_size: int, batch: int, include_nms: bool,
                 conf: float, iou: float, bf16: bool, out: Path) -> Path:
    dtype = torch.bfloat16 if bf16 else torch.float32
    if bf16:
        model.cast(torch.bfloat16)
    spec = torch.zeros((batch, img_size, img_size, 3), dtype=dtype,
                       device=model.device)
    with torch.no_grad():
        exported = torch.export.export(
            Predict(model, include_nms, conf, iou).eval(), (spec,))
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, str(out.with_suffix(".pt2")))
    np.savez(str(out.with_suffix(".params.npz")), **deploy_params(model))
    meta = dict(img_size=img_size, batch=batch, include_nms=include_nms,
                nc=model.cfg.nc, strides=list(model.strides),
                anchors=np.asarray(model.anchors_px).tolist(),
                dtype=str(dtype).split(".")[-1])
    out.with_suffix(".json").write_text(json.dumps(meta, indent=2))
    return out


def main(argv=None):
    args = parse_args(argv)
    args.no_fuse = False
    from rep_yolo_tpu_torch.cli.detect import load_model_and_vars

    model = load_model_and_vars(args)  # fuses by default
    out = export_model(model, args.img_size, args.batch_size,
                       args.include_nms, args.conf_thres, args.iou_thres,
                       args.bf16, Path(args.out))
    print(f"exported to {out}.pt2 / .params.npz / .json")
    return out


if __name__ == "__main__":
    main()
