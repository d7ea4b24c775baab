"""Training CLI (port of ``rep_yolo_tpu/cli/train.py``, the core of its
``_run_training`` loop) on the card, in float32 with TF32 off.

Example:
    python -m rep_yolo_tpu_torch.cli.train --data synthetic:64 \
        --val-data synthetic:32 --epochs 3 --batch-size 8 --img-size 640 \
        --no-augment --no-autoanchor --eval-every 1

Seeded init of the train-form model, the hyp preset's loss gains and
optimizer (simOTA by default, 3-group nesterov SGD with warmup and
one-cycle, gradient accumulation to the nominal batch 64 ramped over the
warmup), the EMA; one JSON line per step (per call of the train step, which
advances the iteration counter) with the loss components and the step's
host ms. Every ``--eval-every`` epochs and at the last one the EMA weights
are scored on the validation set (``train/evaluate.py``; the train-form
model, whose attention runs on K2 on the card), one JSON line each with
the kernel launches of that evaluation. The run
directory (``--project``/``--name``, numbered on, with ``opt.json`` and
``results.txt``) receives ``last`` every epoch, ``best`` on a fitness gain
and ``epoch_NNN`` snapshots (epoch 0, every 25th, the last 5), as the JAX
CLI saves them (``train/checkpoint.py``, the JAX ``.npz`` form); the JAX
CLI's ``init`` snapshot is not written.

``--val-data``: ``synthetic[:N]`` (the generator at seed + 1, held in
memory like the training data), a YOLO directory, a ``.txt`` list or a
dataset YAML (``DetectionDataset.from_path``); without it the training set
is scored, as in the JAX CLI. ``--eval-every 0`` turns evaluation off.

The flags are the JAX CLI's. Paths not ported yet raise instead of being
ignored: a YOLO-directory training set (``--data`` takes ``synthetic[:N]``),
augmentation and autoanchor (``--no-augment`` and ``--no-autoanchor`` are
required), and ``--bf16``, ``--multi-scale``, ``--aux``, ``--resume``,
``--evolve``, ``--multihost`` and the other flags listed in ``NOT_PORTED``.
``--device`` (the port's entry points' flag) picks the device: the card
unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("rep-yolo-tpu-torch train")
    p.add_argument("--cfg", default="cfg/rep_yolo.yaml")
    p.add_argument("--data", required=True,
                   help="'synthetic[:N]' (a YOLO-layout dir is not ported)")
    p.add_argument("--val-data", default=None,
                   help="'synthetic[:N]', a YOLO-layout dir, a .txt list or "
                        "a dataset YAML (default: the training set)")
    p.add_argument("--hyp", default="scratch.p5")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--nc", type=int, default=1)
    p.add_argument("--max-labels", type=int, default=120)
    p.add_argument("--adam", action="store_true")
    p.add_argument("--linear-lr", action="store_true")
    p.add_argument("--no-ota", action="store_true",
                   help="classic ComputeLoss instead of simOTA")
    p.add_argument("--no-accumulate", action="store_true",
                   help="no gradient accumulation to the nominal batch 64")
    p.add_argument("--aux", action="store_true")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--no-autoanchor", action="store_true")
    p.add_argument("--multi-scale", action="store_true")
    p.add_argument("--image-weights", action="store_true")
    p.add_argument("--project", default="runs/train")
    p.add_argument("--name", default="exp")
    p.add_argument("--resume", default=None)
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rbg", action="store_true")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--devices", type=int, default=0)
    p.add_argument("--native-loader", action="store_true")
    p.add_argument("--no-native-loader", action="store_true")
    p.add_argument("--cache-images", default=None, choices=["ram", "disk"])
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--wandb", default=None, metavar="PROJECT")
    p.add_argument("--evolve", type=int, default=0, metavar="N")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


# flag -> (the value that leaves its path unused, what the path is)
NOT_PORTED = {
    "aux": (False, "the aux-head loss"),
    "no_augment": (True, "augmentation (pass --no-augment)"),
    "no_autoanchor": (True, "autoanchor (pass --no-autoanchor)"),
    "multi_scale": (False, "multi-scale training"),
    "image_weights": (False, "image weights"),
    "resume": (None, "checkpoints and resume"),
    "rbg": (False, "JAX's rbg generator"),
    "multihost": (False, "multi-host training"),
    "native_loader": (False, "the native loader"),
    "cache_images": (None, "image caching"),
    "workers": (0, "the native loader"),
    "bf16": (False, "mixed precision"),
    "remat": (False, "rematerialization"),
    "wandb": (None, "logging to Weights & Biases"),
    "evolve": (0, "hyperparameter evolution"),
}


def check_ported(args) -> None:
    for flag, (ok, what) in NOT_PORTED.items():
        if getattr(args, flag) != ok:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: {what} is not ported to "
                f"rep_yolo_tpu_torch yet")
    if args.devices not in (0, 1):
        raise NotImplementedError("--devices: data parallel training is "
                                  "not ported yet")
    if not args.data.startswith("synthetic"):
        raise NotImplementedError("--data: only 'synthetic[:N]' is ported "
                                  "(a YOLO directory needs a decoder)")


def _synthetic_n(spec: str) -> int:
    return int(spec.split(":")[1]) if ":" in spec else 64


class Training(NamedTuple):
    model: object               # models.model.RepYOLO, train form
    state: object               # train.trainer.TrainState
    step: Callable              # the train step
    loader: object              # data.datasets.Loader
    opt_cfg: object             # train.optim.OptimConfig
    accum: int                  # final accumulation count (1: off)


def build_training(args, warmup: bool = True) -> Training:
    """What ``args`` (from ``parse_args``) trains with: the seeded model, the
    synthetic data's loader, the hyp preset's loss and optimizer, the train
    state and step, on ``args.device``. ``warmup=False`` turns the warmup
    off (``warmup_epochs=0, warmup_floor=0``), as a run on one repeated
    batch wants."""
    from rep_yolo_tpu_torch.data.datasets import Loader, make_synthetic_dataset
    from rep_yolo_tpu_torch.device import resolve_device
    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.train import optim as optim_lib
    from rep_yolo_tpu_torch.train.hyp import load_hyp, scale_gains
    from rep_yolo_tpu_torch.train.loss import LossConfig, balance_for
    from rep_yolo_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    check_ported(args)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ds = make_synthetic_dataset(_synthetic_n(args.data), args.img_size,
                                args.nc, args.max_labels, seed=args.seed)
    loader = Loader(ds, args.batch_size, seed=args.seed)

    model = RepYOLO.from_config(args.cfg, nc=args.nc, device=dev)
    model.init(torch.Generator().manual_seed(args.seed))
    hyp = load_hyp(args.hyp)
    ghyp = scale_gains(hyp, model.cfg.nl, model.cfg.nc, args.img_size)
    loss_cfg = LossConfig(
        nc=model.cfg.nc, box_gain=ghyp["box"], obj_gain=ghyp["obj"],
        cls_gain=ghyp["cls"], cls_pw=hyp["cls_pw"], obj_pw=hyp["obj_pw"],
        anchor_t=hyp["anchor_t"], fl_gamma=hyp["fl_gamma"],
        label_smoothing=hyp.get("label_smoothing", 0.0),
        balance=balance_for(model.cfg.nl))
    opt_cfg = optim_lib.OptimConfig(
        lr0=hyp["lr0"], lrf=hyp["lrf"], momentum=hyp["momentum"],
        weight_decay=optim_lib.scaled_weight_decay(hyp["weight_decay"],
                                                   args.batch_size),
        warmup_epochs=hyp["warmup_epochs"] if warmup else 0.0,
        warmup_momentum=hyp["warmup_momentum"],
        warmup_bias_lr=hyp["warmup_bias_lr"], epochs=args.epochs,
        nb=len(loader), linear_lr=args.linear_lr, adam=args.adam,
        **({} if warmup else {"warmup_floor": 0}))
    accum = (1 if args.no_accumulate
             else optim_lib.accumulate_steps(args.batch_size))
    step = make_train_step(model, loss_cfg, opt_cfg, args.img_size,
                           loss_mode="classic" if args.no_ota else "ota",
                           accumulate=accum > 1)
    return Training(model, create_train_state(model, seed=args.seed + 1),
                    step, loader, opt_cfg, accum)


def build_val_set(args):
    """The validation set ``--val-data`` names, or None (score the training
    set)."""
    from rep_yolo_tpu_torch.data.datasets import (DetectionDataset,
                                                  make_synthetic_dataset)

    if not args.val_data:
        return None
    if str(args.val_data).startswith("synthetic"):
        # a different seed: truly held-out images
        return make_synthetic_dataset(_synthetic_n(args.val_data),
                                      args.img_size, args.nc,
                                      args.max_labels, seed=args.seed + 1)
    return DetectionDataset.from_path(args.val_data, args.img_size, args.nc,
                                      args.max_labels)


def run_training(args, emit=print) -> list[dict]:
    """Train as the arguments say; ``emit`` gets each step's JSON line and
    each evaluation's. Returns the step records."""
    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.ops.kernels import launch_counts
    from rep_yolo_tpu_torch.train.checkpoint import save_checkpoint
    from rep_yolo_tpu_torch.train.evaluate import evaluate
    from rep_yolo_tpu_torch.train.trainer import accum_target_for
    from rep_yolo_tpu_torch.utils.general import increment_path

    t = build_training(args)
    dev, nb = t.model.device, len(t.loader)
    out_dir = increment_path(Path(args.project) / args.name)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "opt.json").write_text(json.dumps(vars(args), indent=2))
    val_ds = build_val_set(args) or t.loader.ds
    # the EMA weights are scored in a model of their own
    ema_model = (RepYOLO.from_config(args.cfg, nc=args.nc, device=dev)
                 if args.eval_every else None)
    emit(json.dumps({"train": len(t.loader.ds), "batches_per_epoch": nb,
                     "val": len(val_ds) if ema_model else 0,
                     "device": str(dev), "run_dir": str(out_dir)}))
    records = []
    best_fitness, res = 0.0, None
    for epoch in range(args.epochs):
        for i, batch in enumerate(t.loader.epoch(epoch)):
            inputs = [torch.from_numpy(batch[k]).to(dev)
                      for k in ("images", "hw", "labels", "mask")]
            if t.accum > 1:
                inputs.append(accum_target_for(epoch * nb + i, t.opt_cfg.nw,
                                               t.accum))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            comps = t.step(t.state, *inputs)
            vals = {k: float(v) for k, v in comps.items()}
            ms = (time.perf_counter() - t0) * 1e3
            rec = {"epoch": epoch, "step": t.state.step, **vals, "ms": ms}
            records.append(rec)
            emit(json.dumps(rec))
        ep = [r for r in records if r["epoch"] == epoch]
        with open(out_dir / "results.txt", "a") as f:
            f.write(json.dumps({"epoch": epoch, **{
                k: float(np.mean([r[k] for r in ep]))
                for k in ("box", "obj", "cls", "total")}}) + "\n")
        if ema_model is not None and ((epoch + 1) % args.eval_every == 0
                                      or epoch == args.epochs - 1):
            ema_model.load_state(t.state.ema)
            before = launch_counts()
            res = evaluate(ema_model, val_ds, batch_size=args.batch_size,
                           img_size=args.img_size)
            launched = {k: n - before[k] for k, n in launch_counts().items()
                        if n > before[k]}
            emit(json.dumps({"epoch": epoch, "eval": {
                "P": res.mp, "R": res.mr, "map50": res.map50,
                "map": res.map, "fitness": res.fitness,
                "ms_per_img": list(res.speed_ms)}, "launches": launched}))
            if res.fitness > best_fitness:
                best_fitness = res.fitness
                meta = dict(epoch=epoch, fitness=res.fitness)
                save_checkpoint(out_dir / "best", t.state, meta=meta)
                if epoch >= 200:     # late-best snapshot
                    save_checkpoint(out_dir / f"best_{epoch:03d}", t.state,
                                    meta=meta)
        # cadence (reference train.py:461-483): last every epoch; epoch
        # snapshots at 0, every 25, and the final 5 epochs
        meta = dict(epoch=epoch, fitness=res.fitness if res else 0.0)
        save_checkpoint(out_dir / "last", t.state, meta=meta)
        if epoch == 0 or (epoch + 1) % 25 == 0 or epoch >= args.epochs - 5:
            save_checkpoint(out_dir / f"epoch_{epoch:03d}", t.state,
                            meta=meta)
    if not all(np.isfinite(r["total"]) for r in records):
        raise FloatingPointError("a step's loss is not finite")
    return records


def main(argv=None):
    run_training(parse_args(argv))


if __name__ == "__main__":
    main()
