"""Training CLI (port of ``rep_yolo_tpu/cli/train.py``, the core of its
``_run_training`` loop) on the card, in float32 with TF32 off.

Example, the JAX demo run's configuration (scratch.p5, autoanchor on):
    python -m rep_yolo_tpu_torch.cli.train --data synthetic:768 \
        --val-data synthetic:128 --epochs 24 --batch-size 8 --img-size 640 \
        --hyp scratch.p5 --eval-every 3

Seeded init of the train-form model; autoanchor unless ``--no-autoanchor``
(``utils/autoanchor.py``: the anchors' best possible recall on the
training set, and below 0.98 an evolved set in their place, before the
step is built; the JAX CLI's line is printed and ``anchors.json``,
``{"bpr", "anchors_px"}``, written into the run directory); the hyp
preset's augmentation (on the card, in the train step: mosaic-4 or
mosaic-9 with the random affine, paste-in, cutout, mixup, HSV and flips;
``data/augment.py``), loss gains and optimizer (simOTA by default, 3-group
nesterov SGD with warmup and one-cycle, gradient accumulation to the
nominal batch 64 ramped over the warmup), the EMA; one JSON line per step
(per call of the train step, which advances the iteration counter) with
the loss components, the step's host ms and its wait for the batch
(``wait_ms``). Every ``--eval-every`` epochs
and at the last one the EMA weights are scored on the validation set
(``train/evaluate.py``; the train-form model with the step's anchors,
whose attention runs on K2 on the card), one JSON line each with the
kernel launches of that evaluation. The JAX CLI's text lines are printed:
``epoch i/N box .. obj .. cls .. total .. (s)`` an epoch (its mean losses
and wall seconds) and ``  eval: P .. R .. mAP50 .. mAP ..`` an evaluation.
The run directory (``--project``/``--name``, numbered on) receives, as the
JAX CLI writes them: ``opt.json``; ``hyp.json`` and ``metrics.csv``
(``utils/logger.RunLogger``: the ``train/*`` scalars an epoch, the
``val/*`` ones an evaluation, which its CSV drops as JAX's does);
``results.txt`` (the epoch lines); the checkpoints (``train/checkpoint.py``,
the JAX ``.npz`` form, the generator states in the ``.json``): ``init``
before the first step, ``last`` every epoch, ``best`` on a fitness gain
and ``epoch_NNN`` snapshots (epoch 0, every 25th, the last 5).

``--resume <run>/last`` (any checkpoint path) continues in that run's
directory: the whole train state, the generators where the ``.json`` has
them (a JAX checkpoint has none: they are seeded as at a fresh start, and a
line says so), from the ``.json``'s epoch + 1. As in the JAX CLI, a resumed
run skips autoanchor (it trains with the cfg's anchors, whatever the first
run evolved), writes no ``init`` and starts ``best`` over at fitness 0.

Data (``--data``, as in the JAX CLI): a YOLO-layout directory, a ``.txt``
list of images, a dataset YAML (its ``train`` split; its ``nc`` replaces
``--nc`` and its ``val`` split is the default ``--val-data``), or
``synthetic[:N]``: the seeded generator's N images (64 without N), written
as the JAX CLI writes them (JPEG files and label texts) into
``<run>/synthetic`` and read back from there; ``--val-data synthetic[:N]``
writes ``<run>/synthetic_val`` from seed + 1. Labels go through the label
cache (``labels.cache.npz``); ``--cache-images ram|disk`` pre-decodes the
canvases of both sets. The loader is the native one
(``data/native_loader.py``: cv2 decode threads, the C++ resize, batches in
the epoch's order, the last partial batch kept) whenever its C++ builds,
unless ``--no-native-loader`` (the Python ``Loader``, the last partial batch
dropped); ``--native-loader`` insists on it and raises where it does not
build; ``--workers`` sets its threads. The line naming the loader and
``train: N images, nb batches/epoch`` are printed, and the schedule's
iterations an epoch are the loader's batches. ``--image-weights``
resamples every epoch's images by class-error weights, from the per-class
mAP of the last evaluation. A feed thread prepares batch k + 1 (decoded,
collated, pinned and copied to the card) while step k runs.

Without ``--val-data`` the training set is scored, as in the JAX CLI;
``--eval-every 0`` turns evaluation off.

The flags are the JAX CLI's. Paths not ported yet raise instead of being
ignored: ``--bf16``, ``--multi-scale``, ``--aux``, ``--evolve``,
data-parallel training (``--devices`` above 1, ``--multihost``) and the
other flags listed in ``NOT_PORTED``.
``--device`` (the port's entry points' flag) picks the device: the card
unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import queue
import threading
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("rep-yolo-tpu-torch train")
    p.add_argument("--cfg", default="cfg/rep_yolo.yaml")
    p.add_argument("--data", required=True,
                   help="a YOLO-layout dir, a .txt list of images, a "
                        "dataset YAML or 'synthetic[:N]' (written as JPEG "
                        "files into <run>/synthetic)")
    p.add_argument("--val-data", default=None,
                   help="'synthetic[:N]', a YOLO-layout dir, a .txt list or "
                        "a dataset YAML (default: the YAML's val split, "
                        "else the training set)")
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
    p.add_argument("--native-loader", action="store_true",
                   help="insist on the native loader (cv2 decode threads, "
                        "C++ resize; default: used whenever it builds)")
    p.add_argument("--no-native-loader", action="store_true",
                   help="the Python loader")
    p.add_argument("--cache-images", default=None, choices=["ram", "disk"],
                   help="pre-decode the canvases: in memory, or as .npy "
                        "files beside the images")
    p.add_argument("--workers", type=int, default=0,
                   help="native loader threads (0: min(8, CPUs))")
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
    "multi_scale": (False, "multi-scale training"),
    "rbg": (False, "JAX's rbg generator"),
    "multihost": (False, "multi-host training"),
    "bf16": (False, "mixed precision"),
    "remat": (False, "rematerialization"),
    "wandb": (None, "logging to Weights & Biases"),
    "evolve": (0, "hyperparameter evolution"),
}


def augment_config(args, hyp: dict):
    """The ``AugmentConfig`` of the hyp, as the JAX CLI builds it."""
    from rep_yolo_tpu_torch.data.augment import AugmentConfig

    return AugmentConfig(
        img_size=args.img_size, degrees=hyp["degrees"],
        translate=hyp["translate"], scale=hyp["scale"], shear=hyp["shear"],
        perspective=hyp["perspective"], hsv_h=hyp["hsv_h"],
        hsv_s=hyp["hsv_s"], hsv_v=hyp["hsv_v"], flipud=hyp["flipud"],
        fliplr=hyp["fliplr"], mosaic=hyp["mosaic"],
        mosaic9=hyp.get("mosaic9", 0.2), mixup=hyp["mixup"],
        paste_in=hyp.get("paste_in", 0.0), cutout=hyp.get("cutout", 0.0),
        max_labels=args.max_labels)


def check_ported(args) -> None:
    for flag, (ok, what) in NOT_PORTED.items():
        if getattr(args, flag) != ok:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: {what} is not ported to "
                f"rep_yolo_tpu_torch yet")
    if args.devices not in (0, 1):
        raise NotImplementedError("--devices: data-parallel training (the "
                                  "global batch's BN statistics and loss "
                                  "normalizers, the gradient all-reduce) is "
                                  "not ported to rep_yolo_tpu_torch yet")


def _synthetic_n(spec: str) -> int:
    return int(spec.split(":")[1]) if ":" in spec else 64


class Training(NamedTuple):
    model: object               # models.model.RepYOLO, train form
    state: object               # train.trainer.TrainState
    step: Callable              # the train step
    loader: object              # data.datasets.Loader or NativeLoader
    opt_cfg: object             # train.optim.OptimConfig
    accum: int                  # final accumulation count (1: off)
    augment: Callable | None    # the step's augment_fn (None: --no-augment)
    anchor_bpr: float | None    # autoanchor's BPR of the cfg's anchors
    #                             (None: --no-autoanchor)
    anchors_evolved: bool       # the model carries autoanchor's new set
    hyp: dict                   # the hyp preset's values
    loader_line: str            # "loader: ...", the JAX CLI's line


def autoanchor(args, ds, model, hyp: dict):
    """The JAX CLI's anchor check at train start (reference train.py:285 ->
    utils/autoanchor.py:23-59): the best possible recall of the model's
    anchors on ``ds``; below 0.98, an evolved set that recalls more replaces
    them. -> (model, bpr, evolved)."""
    from rep_yolo_tpu_torch.utils.autoanchor import check_anchors

    bpr, new = check_anchors(ds, model.anchors_px, img_size=args.img_size,
                             thr=hyp["anchor_t"], seed=args.seed)
    if new is None:
        return model, bpr, False
    return model.with_anchors(new), bpr, True


def autoanchor_line(bpr: float, model, evolved: bool) -> str:
    """The line the JAX CLI prints after the check."""
    if not evolved:
        return f"autoanchor: BPR {bpr:.4f} — anchors are a good fit"
    return (f"autoanchor: BPR {bpr:.4f} < 0.98 — evolved new anchors: "
            f"{model.anchors_px.reshape(-1, 2).tolist()}")


def build_train_set(args, root=None):
    """The training set ``--data`` names, as the JAX CLI reads it. A
    dataset YAML sets ``args.nc`` and, without ``--val-data``,
    ``args.val_data`` to its val split. ``synthetic[:N]`` is written into
    ``<root>/synthetic`` and read from there; without ``root`` it stays in
    memory (``InMemoryDataset``)."""
    from rep_yolo_tpu_torch.data.datasets import (DetectionDataset,
                                                  load_dataset_spec,
                                                  make_synthetic_dataset)

    if args.data.endswith((".yaml", ".yml")):
        spec = load_dataset_spec(args.data)
        args.nc = spec["nc"]
        if args.val_data is None and spec["val"]:
            args.val_data = spec["val"]
        if spec["train"] is None:
            raise ValueError(f"{args.data}: the dataset YAML has no train "
                             "split")
        return DetectionDataset.from_path(spec["train"], args.img_size,
                                          args.nc, args.max_labels)
    if args.data.startswith("synthetic"):
        return make_synthetic_dataset(
            _synthetic_n(args.data), args.img_size, args.nc, args.max_labels,
            seed=args.seed, root=root and Path(root) / "synthetic")
    return DetectionDataset.from_path(args.data, args.img_size, args.nc,
                                      args.max_labels)


def make_loader(args, ds):
    """The JAX CLI's loader choice: the native loader when it builds,
    unless ``--no-native-loader``; ``--native-loader`` raises where it does
    not build. -> (loader, the line naming it). An in-memory set has no
    files to decode: the Python loader."""
    from rep_yolo_tpu_torch.data import native_loader as NL
    from rep_yolo_tpu_torch.data.datasets import Loader

    def python_loader():
        return Loader(ds, args.batch_size, shuffle=True, seed=args.seed)

    if not hasattr(ds, "img_files"):
        if args.native_loader:
            raise ValueError("--native-loader decodes image files; the "
                             "in-memory synthetic set has none")
        return python_loader(), "loader: python (in-memory synthetic set)"
    if args.no_native_loader:
        return python_loader(), "loader: python (--no-native-loader)"
    if not args.native_loader and not NL.available():
        return python_loader(), ("loader: python (native loader "
                                 f"unavailable: {NL.build_error()})")
    loader = NL.NativeLoader(ds, args.batch_size, shuffle=True,
                             seed=args.seed, n_threads=args.workers or None)
    return loader, ("loader: native (cv2 decode threads, C++ resize"
                    + (", cached" if args.cache_images else "") + ")")


def build_training(args, warmup: bool = True, root=None) -> Training:
    """What ``args`` (from ``parse_args``) trains with: the seeded model, the
    training set's loader (``build_train_set`` with ``root``,
    ``--cache-images``, ``make_loader``), the hyp preset's loss and
    optimizer (its iterations an epoch: the loader's batches), the train
    state and step, on ``args.device``. ``warmup=False`` turns the warmup
    off (``warmup_epochs=0, warmup_floor=0``), as a run on one repeated
    batch wants."""
    from rep_yolo_tpu_torch.data.augment import augment_batch, draw_batch
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
    ds = build_train_set(args, root)
    if not len(ds):
        raise ValueError(f"--data {args.data}: no images")
    if args.cache_images:
        ds.cache_images(args.cache_images)
    loader, loader_line = make_loader(args, ds)

    model = RepYOLO.from_config(args.cfg, nc=args.nc, device=dev)
    model.init(torch.Generator().manual_seed(args.seed))
    hyp = load_hyp(args.hyp)
    bpr, evolved = None, False
    if not args.no_autoanchor and not args.resume:
        # before the step is built: it captures the model's anchor grid
        model, bpr, evolved = autoanchor(args, ds, model, hyp)
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
    aug_cfg = augment_config(args, hyp)
    augment_fn = None if args.no_augment else (
        lambda im, hw, lb, mk, gen: augment_batch(
            im, hw, lb, mk, draw_batch(gen, im.shape[0], aug_cfg,
                                       lb.shape[1]), aug_cfg))
    accum = (1 if args.no_accumulate
             else optim_lib.accumulate_steps(args.batch_size))
    step = make_train_step(model, loss_cfg, opt_cfg, args.img_size,
                           loss_mode="classic" if args.no_ota else "ota",
                           accumulate=accum > 1, augment_fn=augment_fn)
    return Training(model, create_train_state(model, seed=args.seed + 1),
                    step, loader, opt_cfg, accum, augment_fn, bpr, evolved,
                    hyp, loader_line)


def build_val_set(args, root=None):
    """The validation set ``--val-data`` names, or None (score the training
    set). ``synthetic[:N]`` is the generator at seed + 1 (held-out
    images), written into ``<root>/synthetic_val`` and read from there, or
    in memory without ``root``."""
    from rep_yolo_tpu_torch.data.datasets import (DetectionDataset,
                                                  make_synthetic_dataset)

    if not args.val_data:
        return None
    if str(args.val_data).startswith("synthetic"):
        return make_synthetic_dataset(
            _synthetic_n(args.val_data), args.img_size, args.nc,
            args.max_labels, seed=args.seed + 1,
            root=root and Path(root) / "synthetic_val")
    return DetectionDataset.from_path(args.val_data, args.img_size, args.nc,
                                      args.max_labels)


BATCH_KEYS = ("images", "hw", "labels", "mask")


def feed(batches, dev: torch.device):
    """Yield (the step's input tensors on ``dev``, host ms waited for
    them) for each batch of ``batches``, prepared one batch ahead on a
    thread: the arrays as tensors, on the card pinned and copied before
    the thread hands them over (the copy returns once it has landed, so
    the queue orders it before the step that reads it). At most two
    prepared batches wait; an error in the thread is raised here."""
    slots: queue.Queue = queue.Queue(maxsize=2)
    done = object()
    stop = threading.Event()

    def prepare():
        try:
            for batch in batches:
                inputs = [torch.from_numpy(np.ascontiguousarray(batch[k]))
                          for k in BATCH_KEYS]
                if dev.type == "cuda":
                    inputs = [x.pin_memory().to(dev) for x in inputs]
                if stop.is_set():
                    return
                slots.put(inputs)
            slots.put(done)
        except BaseException as e:      # raised in the consuming thread
            slots.put(e)

    thread = threading.Thread(target=prepare, daemon=True)
    thread.start()
    try:
        while True:
            t = time.perf_counter()
            item = slots.get()
            wait_ms = (time.perf_counter() - t) * 1e3
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item, wait_ms
    finally:
        stop.set()
        while thread.is_alive():        # unblock a thread waiting to put
            try:
                slots.get(timeout=0.05)
            except queue.Empty:
                pass
        thread.join()


def train_epoch(t: Training, batches, epoch: int, emit=None) -> list[dict]:
    """Epoch ``epoch``'s steps over ``batches`` (a loader's epoch) through
    ``feed``: one record a step (epoch, step, the loss components, ``ms``
    the step's host ms, ``wait_ms`` the host ms it waited for its batch),
    each also given to ``emit`` as a JSON line."""
    from rep_yolo_tpu_torch.train.trainer import accum_target_for

    dev, nb = t.model.device, len(t.loader)
    records = []
    for i, (inputs, wait_ms) in enumerate(feed(batches, dev)):
        if t.accum > 1:
            inputs.append(accum_target_for(epoch * nb + i, t.opt_cfg.nw,
                                           t.accum))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        comps = t.step(t.state, *inputs)
        vals = {k: float(v) for k, v in comps.items()}
        ms = (time.perf_counter() - t1) * 1e3
        rec = {"epoch": epoch, "step": t.state.step, **vals, "ms": ms,
               "wait_ms": wait_ms}
        records.append(rec)
        if emit is not None:
            emit(json.dumps(rec))
    return records


def run_training(args, emit=print) -> list[dict]:
    """Train as the arguments say; ``emit`` gets autoanchor's line (where
    it ran), each step's JSON line, each evaluation's and, on ``--resume``,
    the resumed state's. The JAX CLI's text lines (the loader, the training
    set's size, an epoch's mean losses and seconds, an evaluation's scores)
    are printed, and the epoch's also appended to ``results.txt``. Returns
    the step records."""
    from rep_yolo_tpu_torch.device import resolve_device
    from rep_yolo_tpu_torch.models.model import RepYOLO
    from rep_yolo_tpu_torch.ops.kernels import launch_counts
    from rep_yolo_tpu_torch.train.checkpoint import (generator_states,
                                                     load_checkpoint,
                                                     save_checkpoint)
    from rep_yolo_tpu_torch.train.evaluate import evaluate
    from rep_yolo_tpu_torch.utils.general import (increment_path,
                                                  labels_to_class_weights,
                                                  labels_to_image_weights)
    from rep_yolo_tpu_torch.utils.logger import RunLogger

    check_ported(args)
    resolve_device(args.device)
    if args.resume:
        # continue in the resumed run's directory (a fresh increment would
        # orphan the old run's last.json and loop a resume daemon forever)
        out_dir = Path(args.resume).parent
    else:
        out_dir = increment_path(Path(args.project) / args.name)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "opt.json").write_text(json.dumps(vars(args), indent=2))
    t = build_training(args, root=out_dir)
    dev, nb, ds = t.model.device, len(t.loader), t.loader.ds
    print(t.loader_line)
    print(f"train: {len(ds)} images, {nb} batches/epoch")
    if t.anchor_bpr is not None:
        emit(autoanchor_line(t.anchor_bpr, t.model, t.anchors_evolved))
        (out_dir / "anchors.json").write_text(json.dumps(
            {"bpr": t.anchor_bpr, "anchors_px": t.model.anchors_px.tolist()}))
    val_ds = build_val_set(args, out_dir) or ds
    if args.cache_images and val_ds is not ds:
        val_ds.cache_images(args.cache_images)
    # the EMA weights are scored in a model of their own, with the anchors
    # the step trains with
    ema_model = (RepYOLO.from_config(args.cfg, nc=args.nc, device=dev)
                 .with_anchors(t.model.anchors_px)
                 if args.eval_every else None)
    emit(json.dumps({"train": len(t.loader.ds), "batches_per_epoch": nb,
                     "val": len(val_ds) if ema_model else 0,
                     "device": str(dev), "run_dir": str(out_dir)}))
    start_epoch = 0
    if args.resume:
        # the whole TrainState, its generators and the epoch pointer
        load_checkpoint(args.resume, t.state, seed=args.seed + 1)
        meta_path = Path(args.resume).with_suffix(".json")
        if meta_path.exists():
            start_epoch = json.loads(meta_path.read_text()).get("epoch",
                                                                -1) + 1
        print(f"resumed {args.resume} at epoch {start_epoch}")
        emit(json.dumps({"resumed": str(args.resume),
                         "start_epoch": start_epoch, "step": t.state.step,
                         "generators_sha256": {
                             k: hashlib.sha256(v.encode()).hexdigest()
                             for k, v in generator_states(t.state).items()}}))
    logger = RunLogger(out_dir, wandb_project=args.wandb)
    logger.log_config("hyp", t.hyp)
    nc = t.model.cfg.nc
    if args.image_weights:
        class_w = labels_to_class_weights(ds.labels, nc)
    maps = np.zeros(nc)         # per-class mAP of the last evaluation
    records = []
    best_fitness, res = 0.0, None
    results_file = out_dir / "results.txt"
    if not args.resume:
        # the pre-training snapshot
        save_checkpoint(out_dir / "init", t.state, meta=dict(epoch=-1))
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        if args.image_weights:
            # class error weights -> image weights (reference
            # train.py:326-330)
            cw = class_w * (1 - maps) ** 2 / nc
            iw = labels_to_image_weights(ds.labels, nc, cw)
            batches = t.loader.epoch(epoch, image_weights=iw)
        else:
            batches = t.loader.epoch(epoch)
        steps = train_epoch(t, batches, epoch, emit)
        records += steps
        mloss = np.zeros(4)
        for r in steps:
            mloss += np.asarray([r[k] for k in ("box", "obj", "cls",
                                                "total")])
        mloss /= max(len(steps), 1)
        line = (f"epoch {epoch}/{args.epochs - 1} "
                f"box {mloss[0]:.4f} obj {mloss[1]:.4f} cls {mloss[2]:.4f} "
                f"total {mloss[3]:.4f} ({time.time() - t0:.1f}s)")
        print(line)
        with open(results_file, "a") as f:
            f.write(line + "\n")
        logger.log_scalars(epoch, {"train/box": mloss[0],
                                   "train/obj": mloss[1],
                                   "train/cls": mloss[2],
                                   "train/total": mloss[3]})
        if ema_model is not None and ((epoch + 1) % args.eval_every == 0
                                      or epoch == args.epochs - 1):
            ema_model.load_state(t.state.ema)
            before = launch_counts()
            res = evaluate(ema_model, val_ds, batch_size=args.batch_size,
                           img_size=args.img_size)
            launched = {k: n - before[k] for k, n in launch_counts().items()
                        if n > before[k]}
            print(f"  eval: P {res.mp:.3f} R {res.mr:.3f} "
                  f"mAP50 {res.map50:.3f} mAP {res.map:.3f}")
            for c, d in res.per_class.items():
                if 0 <= c < len(maps):
                    maps[c] = d.get("ap", 0.0)
            emit(json.dumps({"epoch": epoch, "eval": {
                "P": res.mp, "R": res.mr, "map50": res.map50,
                "map": res.map, "fitness": res.fitness,
                "ms_per_img": list(res.speed_ms)}, "launches": launched}))
            logger.log_scalars(epoch, {"val/P": res.mp, "val/R": res.mr,
                                       "val/mAP50": res.map50,
                                       "val/mAP": res.map,
                                       "val/fitness": res.fitness})
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
    logger.close()
    if hasattr(t.loader, "close"):
        t.loader.close()
    print(f"done. results in {out_dir}")
    if not all(np.isfinite(r["total"]) for r in records):
        raise FloatingPointError("a step's loss is not finite")
    return records


def main(argv=None):
    run_training(parse_args(argv))


if __name__ == "__main__":
    main()
