"""Checkpoints (port of ``rep_yolo_tpu/train/checkpoint.py``).

The port writes the JAX package's ``.npz`` form: one array per leaf of the
JAX ``TrainState`` (params, batch_stats, opt (step, momentum, second), ema
(updates, variables), rng, acc, acc_n), keyed by its tree path as the JAX
``_flatten`` makes it (``0/l0/rbr_conv_0_conv/w/kernel``,
``3/1/batch_stats/l2/cv1/bn/norm/var``, ...), and the metadata beside it as
``.json``, with the port's two generator states (dropout and augmentation)
as port-only keys there (``GENERATOR_KEYS``), so a resumed run continues
the same random streams. A checkpoint of either package so loads in the
other: the JAX ``load_checkpoint`` reads the port's file into its
template, and ``load_checkpoint`` here reads a JAX ``.npz`` through
``utils.weights.train_state_from_jax`` (the port's files go out through its
inverse, ``train_state_to_jax``). The JAX package's orbax directories are
not read (they need orbax): save with its ``.npz`` fallback.

Cadence (``cli.train``): ``init`` before the first step, ``last`` every
epoch, ``best`` on a fitness gain, ``epoch_NNN`` snapshots.
``strip_to_deploy`` takes the EMA weights; ``save_checkpoint`` of its
state dict (with ``net=``) writes the JAX variables tree {params,
batch_stats}, as the JAX ``save_checkpoint`` of its ``strip_to_deploy``
does. ``read_weights`` gives the weights to serve
from either form, of either package (``serve --ckpt``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from types import SimpleNamespace
from typing import Mapping

import numpy as np
import torch

from rep_yolo_tpu_torch.utils.weights import (float_leaf, state_dict_from_jax,
                                              state_dict_to_jax,
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


# the .json keys of a TrainState's generator states (hex of get_state()):
# the dropout generator, then the augment generator
GENERATOR_KEYS = ("torch_generator", "torch_aug_generator")


def generator_states(state) -> dict[str, str]:
    """A ``TrainState``'s two generator states, as ``save_checkpoint``
    writes them into the ``.json``."""
    gens = (state.generator, state.aug_generator)
    return {k: g.get_state().numpy().tobytes().hex()
            for k, g in zip(GENERATOR_KEYS, gens)}


def save_checkpoint(path: str | Path, state, meta: dict | None = None,
                    net: torch.nn.Module | None = None):
    """Write a port ``TrainState`` as ``<path>.npz`` (the JAX form) and
    ``meta`` with its generator states as ``<path>.json``. A bare state
    dict (``strip_to_deploy``'s) is written as the JAX variables tree
    {params, batch_stats}, and ``meta`` alone; it needs ``net``, the
    train-form network it belongs to, for the JAX paths."""
    path = Path(path).resolve()
    if isinstance(state, Mapping):
        if net is None:
            raise ValueError("save_checkpoint: a bare state dict needs net=, "
                             "the train-form network it belongs to")
        tree = state_dict_to_jax(net, state)
    else:
        tree = train_state_to_jax(state)
        meta = {**(meta or {}), **generator_states(state)}
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(path.with_suffix(".npz")), **_flatten(tree))
    if meta is not None:
        path.with_suffix(".json").write_text(json.dumps(meta, indent=2))


def _read_npz(path: str | Path) -> dict:
    """``<path>.npz`` as {key: array}; an orbax directory raises."""
    path = Path(path).resolve()
    orbax_dir = Path(str(path.with_suffix("")) + ".orbax")
    if orbax_dir.exists():
        raise NotImplementedError(
            f"{orbax_dir} is an orbax checkpoint, which the port does not "
            "read: save it in the JAX package's .npz form (its "
            "save_checkpoint without orbax, or np.savez of _flatten(state))")
    with np.load(str(path.with_suffix(".npz"))) as z:
        return {k: z[k] for k in z.files}


def read_checkpoint(path: str | Path) -> dict:
    """A checkpoint of either package -> the port's trees:
    ``train_state_from_jax``'s {"state", "momentum", "second", "ema",
    "step", "ema_updates"} and {"acc", "acc_n"}."""
    tree = _unflatten(_read_npz(path))
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


_TRAIN_STATE = {"0", "1", "2", "3", "4", "5", "6"}
_VARIABLES = {"params", "batch_stats"}


def read_weights(path: str | Path) -> dict[str, np.ndarray]:
    """The weights to serve from a checkpoint ``.npz`` of either package,
    its form told by its top-level keys:

    - a ``TrainState`` ("0" params, "1" batch_stats, "2" opt, "3" ema
      (updates, variables), ...): its EMA weights, as
      ``read_checkpoint(path)["ema"]`` gives them (the JAX ``cli/detect.py``
      serves ``state.ema.variables``);
    - a variables tree ("params", "batch_stats"), as ``strip_to_deploy``
      then ``save_checkpoint`` write it in either package:
      ``state_dict_from_jax`` of it, bfloat16 leaves (``half=True``) cast
      up to float32 first.

    Anything else raises ``ValueError`` naming the keys found."""
    flat = _read_npz(path)
    top = {k.split("/", 1)[0] for k in flat}
    if {"0", "3"} <= top <= _TRAIN_STATE:
        return state_dict_from_jax(_unflatten(
            {k: v for k, v in flat.items() if k.startswith("3/1/")})["3"]["1"])
    if "params" in top and top <= _VARIABLES:
        return state_dict_from_jax(
            _unflatten({k: float_leaf(v) for k, v in flat.items()}))
    raise ValueError(
        f"{Path(path).with_suffix('.npz')}: neither a TrainState checkpoint "
        f"(top-level keys 0-6, 3 = ema) nor a variables tree (params, "
        f"batch_stats); its top-level keys are {sorted(top)} (e.g. "
        f"{sorted(flat)[:4]})")


def load_checkpoint(path: str | Path, state, seed: int | None = None):
    """Load a checkpoint of either package into the port ``TrainState``
    ``state`` (its template, as in the JAX package), in place; returns it.

    The generator states come from the ``.json`` where it has them (a port
    checkpoint). A JAX checkpoint has none: with ``seed`` both generators
    are seeded as ``create_train_state(model, seed)`` seeds them, and a
    line says so; without, they stay as the template has them."""
    from rep_yolo_tpu_torch.train.trainer import seed_generators

    ck = read_checkpoint(path)
    meta_path = Path(path).resolve().with_suffix(".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    if all(k in meta for k in GENERATOR_KEYS):
        for k, g in zip(GENERATOR_KEYS,
                        (state.generator, state.aug_generator)):
            g.set_state(torch.frombuffer(bytearray.fromhex(meta[k]),
                                         dtype=torch.uint8))
    elif seed is not None:
        seed_generators(state, seed)
        print(f"{path}: no generator states (a JAX checkpoint); the dropout "
              f"and augment generators are seeded from {seed} as at a "
              f"fresh start")
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
