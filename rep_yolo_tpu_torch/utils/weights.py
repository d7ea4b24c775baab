"""Weights in and out of the port.

- ``load_reference_npz``: a reference-keyed ``.npz`` (torch state-dict keys,
  OIHW kernels), e.g. ``tests/golden/model_weights.npz``.
- ``state_dict_from_jax``: the JAX package's variables, given as nested
  dicts of numpy arrays, -> the same reference keys. Its own copy of the
  key mapping of ``rep_yolo_tpu/utils/torch_import.py`` (HWIO -> OIHW,
  ``ia_``/``im_`` reshapes). ``train_state_from_jax`` carries a JAX
  ``TrainState`` (weights, SGD momentum, EMA, counters) and any
  params-shaped tree (grads) through the same map.
- ``jax_paths`` / ``state_dict_to_jax`` / ``train_state_to_jax``: the
  inverse, a train-form network's state dict (and a port ``TrainState``) ->
  the JAX package's trees, path for path (OIHW -> HWIO, the flax ``w`` and
  ``norm`` submodules put back).
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


def bf16_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A bfloat16 tensor as the 2-byte void array that ``np.savez`` writes
    for a JAX bfloat16 leaf (numpy has no bfloat16)."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.dtype("V2"))


def float_leaf(a: np.ndarray) -> np.ndarray:
    """A leaf as read from an ``.npz``: a bfloat16 one (2-byte void, as JAX
    bfloat16 arrays are saved) cast up to float32, others as they are."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
                << 16).view(np.float32)
    return a


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


def _jax_components(parts: list[str]) -> list[str]:
    """Torch module-name components -> one JAX module path (the inverse of
    ``_map_components`` but for the ``w`` / ``norm`` submodules, which
    ``jax_paths`` adds from the module types)."""
    out: list[str] = []
    i = 0
    while i < len(parts):
        c = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else ""
        if c == "model" and nxt.isdigit():
            out.append(f"l{nxt}")
        elif re.fullmatch(r"stage\d", c) and nxt == "0":
            out.append(c)
        elif c == "rbr_conv" and nxt.isdigit() and i + 2 < len(parts):
            out.append(f"rbr_conv_{nxt}_{parts[i + 2]}")
            i += 1
        elif c == "rbr_scale" and nxt in ("conv", "bn"):
            out.append(f"rbr_scale_{nxt}")
        elif c in ("rbr_dense", "rbr_1x1") and nxt in ("0", "1"):
            out.append(f"{c}_{'conv' if nxt == '0' else 'bn'}")
        elif c == "gsb" and nxt.isdigit():
            out.append(f"gsb_{nxt}")
        elif c == "conv_lighting" and nxt in ("0", "1"):
            out.append("gs1" if nxt == "0" else "gs2")
        elif c in ("m", "m1", "m2", "ia", "im") and nxt.isdigit():
            out.append(f"{c}_{nxt}")
        else:
            out.append(c)
            i += 1
            continue
        i += 2
    return out


def jax_paths(net: torch.nn.Module) -> dict[str, tuple[str, tuple[str, ...]]]:
    """{state-dict key: (JAX collection, path in it)} of a train-form
    network, e.g. ``model.2.cv1.conv.weight`` -> ("params", ("l2", "cv1",
    "conv", "w", "kernel")), ``model.2.cv1.bn.running_var`` ->
    ("batch_stats", ("l2", "cv1", "bn", "norm", "var"))."""
    from rep_yolo_tpu_torch.nn import blocks as B

    heads = {n for n, m in net.named_modules() if isinstance(m, B.IDetect)}
    out = {}
    for name, mod in net.named_modules():
        comps = _jax_components(name.split(".")) if name else []
        p = f"{name}." if name else ""
        own = [(k, "params") for k, _ in mod.named_parameters(recurse=False)]
        own += [(k, "batch_stats") for k, _ in mod.named_buffers(recurse=False)]
        for leaf, coll in own:
            if isinstance(mod, B.BN):
                path = comps + ["norm", {"weight": "scale", "bias": "bias",
                                         "running_mean": "mean",
                                         "running_var": "var"}[leaf]]
            elif isinstance(mod, torch.nn.Conv2d):
                in_head = any(name.startswith(f"{h}.m.") for h in heads)
                path = comps + ([] if in_head else ["w"]) + [
                    "kernel" if leaf == "weight" else leaf]
            elif isinstance(mod, B.Implicit):
                path = comps                     # l24/ia_0, l24/im_0
            else:
                path = comps + [leaf]            # the attention gamma
            out[p + leaf] = (coll, tuple(path))
    return out


def state_dict_to_jax(net: torch.nn.Module, state: Mapping,
                      collections=("params", "batch_stats")) -> dict:
    """A train-form state dict (or a params-keyed one: momentum, grads)
    -> {collection: nested dict of numpy arrays} as the JAX package holds
    its variables; ``state_dict_from_jax`` of it gives ``state`` back.
    bfloat16 tensors become 2-byte void arrays (``bf16_to_numpy``)."""
    out: dict = {c: {} for c in collections}
    for key, (coll, path) in jax_paths(net).items():
        if coll not in out or key not in state:
            continue
        t = state[key]
        if torch.is_tensor(t):
            a = (bf16_to_numpy(t) if t.dtype == torch.bfloat16
                 else t.detach().cpu().numpy())
        else:
            a = np.asarray(t)
        if path[-1] == "kernel" and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)          # OIHW -> HWIO
        elif path[-1].startswith(("ia_", "im_")):
            a = a.transpose(0, 2, 3, 1)          # (1,C,1,1)->(1,1,1,C)
        node = out[coll]
        for comp in path[:-1]:
            node = node.setdefault(comp, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return out


def train_state_to_jax(state) -> tuple:
    """A port ``TrainState`` -> the JAX ``TrainState`` as plain nested
    tuples and dicts of numpy arrays, field for field: (params,
    batch_stats, opt (step, momentum, second), ema (updates, variables),
    rng, acc, acc_n). The rng is the key the dropout generator was seeded
    from (``[0, seed]``, as ``jax.random.PRNGKey(seed)``): a torch
    generator's state has no JAX key."""
    net = state.model.net
    var = state_dict_to_jax(net, net.state_dict())
    params_of = lambda d: state_dict_to_jax(net, d, ("params",))["params"]  # noqa: E731
    i32 = lambda v: np.asarray(v, np.int32)  # noqa: E731
    seed = state.generator.initial_seed() & 0xFFFFFFFF
    return (var["params"], var["batch_stats"],
            (i32(state.step), params_of(state.momentum),
             params_of(state.second)),
            (i32(state.ema_updates), state_dict_to_jax(net, state.ema)),
            np.asarray([0, seed], np.uint32), params_of(state.acc),
            i32(state.acc_n))
