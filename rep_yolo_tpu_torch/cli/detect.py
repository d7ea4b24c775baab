"""Detection CLI (port of ``rep_yolo_tpu/cli/detect.py``): so far only
``load_model_and_vars``, which ``cli.test`` uses. ``main`` (image and
video sources, annotated output, ``--augment``) is not ported yet."""

from __future__ import annotations

import torch


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


def main(argv=None):
    raise NotImplementedError("rep_yolo_tpu_torch.cli.detect: only "
                              "load_model_and_vars is ported yet")


if __name__ == "__main__":
    main()
