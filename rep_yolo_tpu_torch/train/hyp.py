"""Hyperparameter presets and loader (port of ``rep_yolo_tpu/train/hyp.py``:
the reference's data/hyp.scratch.p5.yaml and hyp.scratch.tiny.yaml, and the
runtime gain rescale of reference train.py:295-297)."""

from __future__ import annotations

import yaml

# data/hyp.scratch.p5.yaml, verbatim values
SCRATCH_P5: dict[str, float] = dict(
    lr0=0.01, lrf=0.1, momentum=0.937, weight_decay=0.0005,
    warmup_epochs=3.0, warmup_momentum=0.8, warmup_bias_lr=0.1,
    box=0.05, cls=0.3, cls_pw=1.0, obj=0.7, obj_pw=1.0,
    iou_t=0.20, anchor_t=4.0, fl_gamma=0.0,
    hsv_h=0.015, hsv_s=0.7, hsv_v=0.4,
    degrees=0.0, translate=0.2, scale=0.9, shear=0.0, perspective=0.0,
    flipud=0.0, fliplr=0.5,
    mosaic=1.0, mixup=0.15, copy_paste=0.0, paste_in=0.15,
    label_smoothing=0.0,
)

# data/hyp.scratch.tiny.yaml differences
SCRATCH_TINY: dict[str, float] = {**SCRATCH_P5, **dict(
    lrf=0.01, box=0.05, cls=0.5, obj=1.0,
    hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, translate=0.1, scale=0.5,
    mosaic=1.0, mixup=0.05, paste_in=0.05,
)}

PRESETS = {"scratch.p5": SCRATCH_P5, "scratch.tiny": SCRATCH_TINY}


def load_hyp(spec: str | dict | None) -> dict[str, float]:
    """A preset name, a dict of overrides, or a YAML file (over p5)."""
    if spec is None:
        return dict(SCRATCH_P5)
    if isinstance(spec, dict):
        return {**SCRATCH_P5, **spec}
    if spec in PRESETS:
        return dict(PRESETS[spec])
    with open(spec) as f:
        return {**SCRATCH_P5, **yaml.safe_load(f)}


def scale_gains(hyp: dict, nl: int, nc: int, img_size: int) -> dict:
    """box *= 3/nl; cls *= nc/80 * 3/nl; obj *= (img/640)^2 * 3/nl."""
    out = dict(hyp)
    out["box"] = hyp["box"] * 3.0 / nl
    out["cls"] = hyp["cls"] * nc / 80.0 * 3.0 / nl
    out["obj"] = hyp["obj"] * (img_size / 640.0) ** 2 * 3.0 / nl
    return out
