"""Weights in and out of the port.

- ``load_reference_npz``: a reference-keyed ``.npz`` (torch state-dict keys,
  OIHW kernels), e.g. ``tests/golden/model_weights.npz``.
- ``state_dict_from_jax``: the JAX package's variables, given as nested
  dicts of numpy arrays, -> the same reference keys. Its own copy of the
  key mapping of ``rep_yolo_tpu/utils/torch_import.py`` (HWIO -> OIHW,
  ``ia_``/``im_`` reshapes). ``train_state_from_jax`` carries a JAX
  ``TrainState`` (weights, SGD momentum, EMA, counters) and any
  params-shaped tree (grads) through the same map.
- ``load_weights``: strict load that ignores only the reference's dead
  entries (parameters no forward reads).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# Reference entries that no forward reads: DER's cv3_1/cv3_2, VoVGSCSP's
# res, the detect anchors (derived from the config here) and BN counters.
_DEAD = re.compile(r"(^|\.)(cv3_1|cv3_2|res)\.|\.anchors$|\.anchor_grid$"
                   r"|num_batches_tracked$")


def load_reference_npz(path) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_weights(net: torch.nn.Module, state: Mapping) -> None:
    """Load ``state`` into ``net``: every key of the net must be present;
    extra keys must be dead reference entries."""
    own = net.state_dict()
    extra = [k for k in state if k not in own and not _DEAD.search(k)]
    missing = [k for k in own if k not in state]
    if extra or missing:
        raise KeyError(f"state mismatch: {len(missing)} missing (e.g. "
                       f"{missing[:4]}), {len(extra)} unexpected (e.g. "
                       f"{extra[:4]})")
    dev = next(iter(own.values())).device
    loaded = {}
    for k, ref in own.items():
        t = torch.as_tensor(np.array(state[k]) if not torch.is_tensor(
            state[k]) else state[k])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        loaded[k] = t.to(device=dev, dtype=ref.dtype)
    net.load_state_dict(loaded, strict=True)


def _map_components(parts: list[str]) -> list[str]:
    """One JAX module path (component list) -> torch key components."""
    out: list[str] = []
    for comp in parts:
        if re.fullmatch(r"l\d+", comp):
            out += ["model", comp[1:]]
        elif re.fullmatch(r"stage\d", comp):
            out += [comp, "0"]
        elif (m := re.fullmatch(r"rbr_conv_(\d+)_(conv|bn)", comp)):
            out += ["rbr_conv", m.group(1), m.group(2)]
        elif (m := re.fullmatch(r"rbr_scale_(conv|bn)", comp)):
            out += ["rbr_scale", m.group(1)]
        elif comp in ("rbr_dense_conv", "rbr_dense_bn", "rbr_1x1_conv",
                      "rbr_1x1_bn"):
            base, kind = comp.rsplit("_", 1)
            out += [base, "0" if kind == "conv" else "1"]
        elif (m := re.fullmatch(r"gsb_(\d+)", comp)):
            out += ["gsb", m.group(1)]
        elif comp in ("gs1", "gs2"):
            out += ["conv_lighting", "0" if comp == "gs1" else "1"]
        elif (m := re.fullmatch(r"(m2?|m1)_(\d+)", comp)):
            out += [m.group(1), m.group(2)]
        elif comp in ("w", "norm"):
            pass
        else:
            out.append(comp)
    return out


_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var", "bias": "bias"}


def state_dict_from_jax(variables: Mapping) -> dict[str, np.ndarray]:
    """JAX variables {'params', 'batch_stats'} (nested dicts of arrays) ->
    the port's unfused, reference-keyed state dict (numpy, f32; a float64
    tree stays float64)."""
    out: dict[str, np.ndarray] = {}

    def walk(tree, path):
        for name, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + [name])
                continue
            comps = _map_components(path)
            a = np.asarray(val)
            a = a if a.dtype == np.float64 else a.astype(np.float32)
            if name.startswith(("ia_", "im_")):
                comps += [name[:2], name[3:], "implicit"]
                a = a.transpose(0, 3, 1, 2)          # (1,1,1,C)->(1,C,1,1)
            else:
                comps.append(_LEAF.get(name, name))
                if name == "kernel" and a.ndim == 4:
                    a = a.transpose(3, 2, 0, 1)      # HWIO -> OIHW
            out[".".join(comps)] = np.ascontiguousarray(a)

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), [])
    return out


def train_state_from_jax(state) -> dict:
    """A JAX ``TrainState`` (``params``, ``batch_stats``, ``opt``, ``ema``)
    -> {"state": weights and BN statistics, "momentum": SGD buffer (Adam m),
    "second": Adam v, "ema": the EMA's weights and statistics, "step",
    "ema_updates"}, each tree keyed like the port's state dict. A bare
    params-shaped tree (e.g. grads) goes through
    ``state_dict_from_jax({"params": tree})``."""
    return {"state": state_dict_from_jax({"params": state.params,
                                          "batch_stats": state.batch_stats}),
            "momentum": state_dict_from_jax({"params": state.opt.momentum}),
            "second": state_dict_from_jax({"params": state.opt.second}),
            "ema": state_dict_from_jax(state.ema.variables),
            "step": int(state.opt.step),
            "ema_updates": int(state.ema.updates)}
