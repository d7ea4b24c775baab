"""Checkpoints (port of ``rep_yolo_tpu/train/checkpoint.py``).

The port writes the JAX package's ``.npz`` form: one array per leaf of the
JAX ``TrainState`` (params, batch_stats, opt (step, momentum, second), ema
(updates, variables), rng, acc, acc_n), keyed by its tree path as the JAX
``_flatten`` makes it (``0/l0/rbr_conv_0_conv/w/kernel``,
``3/1/batch_stats/l2/cv1/bn/norm/var``, ...), and the metadata beside it as
``.json``. A checkpoint of either package so loads in the other: the JAX
``load_checkpoint`` reads the port's file into its template, and
``load_checkpoint`` here reads a JAX ``.npz`` through
``utils.weights.train_state_from_jax`` (the port's files go out through its
inverse, ``train_state_to_jax``). The JAX package's orbax directories are
not read (they need orbax): save with its ``.npz`` fallback.

Cadence (``cli.train``): ``last`` every epoch, ``best`` on a fitness gain,
``epoch_NNN`` snapshots. ``strip_to_deploy`` takes the EMA weights.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from rep_yolo_tpu_torch.utils.weights import (state_dict_from_jax,
                                              train_state_from_jax,
                                              train_state_to_jax)


def _flatten(tree, prefix=""):
    """The JAX ``_flatten``: dict keys and tuple positions joined by /."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat) -> dict:
    """Keys joined by / -> nested dicts (tuple positions stay string
    keys)."""
    out: dict = {}
    for key in flat:
        node = out
        *head, leaf = key.split("/")
        for comp in head:
            node = node.setdefault(comp, {})
        node[leaf] = flat[key]
    return out


def save_checkpoint(path: str | Path, state, meta: dict | None = None):
    """Write a port ``TrainState`` as ``<path>.npz`` (the JAX form) and
    ``meta`` as ``<path>.json``."""
    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(path.with_suffix(".npz")),
             **_flatten(train_state_to_jax(state)))
    if meta is not None:
        path.with_suffix(".json").write_text(json.dumps(meta, indent=2))


def read_checkpoint(path: str | Path) -> dict:
    """A checkpoint of either package -> the port's trees:
    ``train_state_from_jax``'s {"state", "momentum", "second", "ema",
    "step", "ema_updates"} and {"acc", "acc_n"}."""
    path = Path(path).resolve()
    orbax_dir = Path(str(path.with_suffix("")) + ".orbax")
    if orbax_dir.exists():
        raise NotImplementedError(
            f"{orbax_dir} is an orbax checkpoint, which the port does not "
            "read: save it in the JAX package's .npz form (its "
            "save_checkpoint without orbax, or np.savez of _flatten(state))")
    with np.load(str(path.with_suffix(".npz"))) as z:
        tree = _unflatten({k: z[k] for k in z.files})
    opt, ema = tree["2"], tree["3"]
    jax_state = SimpleNamespace(
        params=tree["0"], batch_stats=tree.get("1", {}),
        opt=SimpleNamespace(step=opt["0"], momentum=opt.get("1", {}),
                            second=opt.get("2", {})),
        ema=SimpleNamespace(updates=ema["0"], variables=ema["1"]))
    out = train_state_from_jax(jax_state)
    out["acc"] = state_dict_from_jax({"params": tree.get("5", {})})
    out["acc_n"] = int(tree.get("6", 0))
    return out


def load_checkpoint(path: str | Path, state):
    """Load a checkpoint of either package into the port ``TrainState``
    ``state`` (its template, as in the JAX package), in place; returns
    it."""
    ck = read_checkpoint(path)
    model = state.model
    model.load_state(ck["state"])
    dev = model.device

    def fill(dst: dict, src: dict):
        for k, t in dst.items():
            t.copy_(torch.as_tensor(src[k], dtype=t.dtype).to(dev))

    with torch.no_grad():
        fill(state.momentum, ck["momentum"])
        fill(state.second, ck["second"])
        fill(state.ema, ck["ema"])
        if ck["acc"]:
            fill(state.acc, ck["acc"])
    state.step, state.ema_updates = ck["step"], ck["ema_updates"]
    state.acc_n = ck["acc_n"]
    return state


def latest_run(root: str | Path = "runs/train") -> Path | None:
    """Most recent last checkpoint (reference get_latest_run,
    utils/general.py:46-49)."""
    root = Path(root)
    cands = sorted(root.glob("**/last.json"), key=os.path.getmtime) \
        if root.exists() else []
    return cands[-1].with_suffix("") if cands else None


def strip_to_deploy(state_or_weights, half: bool = True) -> dict:
    """The strip_optimizer analog (reference utils/general.py:1145-1158):
    a ``TrainState``'s EMA weights (or a bare state dict), the optimizer
    and counters dropped, float32 halved to bfloat16 with ``half``. Fusion
    to deploy weights is a separate step (``RepYOLO.fuse``)."""
    w = getattr(state_or_weights, "ema", None)
    w = dict(state_or_weights if w is None else w)
    if half:
        w = {k: v.to(torch.bfloat16)
             if torch.is_tensor(v) and v.dtype == torch.float32 else v
             for k, v in w.items()}
    return w
