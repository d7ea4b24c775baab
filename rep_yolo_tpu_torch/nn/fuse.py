"""Reparameterization as a pure transform of a reference-keyed state dict.

Port of ``rep_yolo_tpu/nn/fuse.py`` on torch keys and OIHW kernels, f32:

- Conv+BN fold (``P.conv.weight`` + ``P.bn.*`` -> ``P.conv.weight/bias``);
- RepConv 3x3 || 1x1 || BN-identity -> ``P.rbr_reparam``;
- RepS_Block branches (kxk convs, 1x1 scale, BN skip) -> ``P.reparam_conv``;
- IDetect implicit fold: bias += W @ ia; W, bias *= im;
- attention packing: the axial blocks' folded q/k/v convs and their
  post-SiLU BNs (``bn``, ``bn1``, which cannot fold into a conv) become
  the constants the kernels take, ``P.wqk``, ``P.pq``, ``P.pv`` (packing
  of ``rep_yolo_tpu/nn/blocks.py:1326-1359``).

Everything without a pattern passes through. The result loads into the
``deploy=True`` network. A state whose convs are already folded (the JAX
package's fused variables, carried over) only gets the attention packing.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")


def _bn_terms(sd: dict, p: str):
    t = sd[f"{p}.weight"] / torch.sqrt(sd[f"{p}.running_var"] + BN_EPS)
    return t, sd[f"{p}.bias"] - sd[f"{p}.running_mean"] * t


def _fold(kernel: torch.Tensor, sd: dict, bn: str):
    t, beta = _bn_terms(sd, bn)
    return kernel * t[:, None, None, None], beta


def _identity_kernel(k: int, cin: int, cout: int, ref: torch.Tensor):
    w = torch.zeros((cout, cin, k, k), dtype=ref.dtype, device=ref.device)
    idx = torch.arange(cout, device=ref.device)
    w[idx, idx % cin, k // 2, k // 2] = 1.0
    return w


def _pad_to(kernel: torch.Tensor, k: int):
    p = (k - kernel.shape[-1]) // 2
    return F.pad(kernel, (p, p, p, p))


def _prefixes(sd: dict, suffix: str) -> list[str]:
    return sorted({k[:-len(suffix)] for k in sd if k.endswith(suffix)})


def _consume(sd: dict, prefix: str) -> None:
    for key in [k for k in sd if k.startswith(prefix)]:
        del sd[key]


def _densify_grouped_1x1(w: torch.Tensor, c1: int) -> torch.Tensor:
    """Grouped 1x1 OIHW weight (cout, c1/g, 1, 1) -> dense (cout, c1):
    output o reads input group o // (cout / g)."""
    cout, cin_g = w.shape[0], w.shape[1]
    g = c1 // cin_g
    o = torch.arange(cout, device=w.device)
    cols = (o // (cout // g))[:, None] * cin_g \
        + torch.arange(cin_g, device=w.device)[None]
    dense = torch.zeros((cout, c1), dtype=w.dtype, device=w.device)
    return dense.scatter_(1, cols, w[:, :, 0, 0])


def _bn_affine(sd: dict, p: str):
    a = sd.pop(f"{p}.weight") * torch.rsqrt(sd.pop(f"{p}.running_var")
                                            + BN_EPS)
    c = sd.pop(f"{p}.bias") - sd.pop(f"{p}.running_mean") * a
    sd.pop(f"{p}.num_batches_tracked", None)
    return a, c


def _pack_attention(sd: dict, p: str) -> dict:
    """Folded ``{p}query_conv``/``key_conv``/``value_conv`` and the BNs
    ``{p}bn``, ``{p}bn1`` -> {``{p}wqk`` (2*c8, C), ``{p}pq`` (3, 2*c8):
    conv bias, BN scale, BN shift; ``{p}pv`` (4, C): depthwise weight,
    bias, BN scale, BN shift}."""
    wv = sd.pop(f"{p}value_conv.conv.weight")
    c1 = wv.shape[0]
    wq = _densify_grouped_1x1(sd.pop(f"{p}query_conv.conv.weight"), c1)
    wk = _densify_grouped_1x1(sd.pop(f"{p}key_conv.conv.weight"), c1)
    a_qk, c_qk = _bn_affine(sd, f"{p}bn")
    a_v, c_v = _bn_affine(sd, f"{p}bn1")
    pq = torch.stack([torch.cat([sd.pop(f"{p}query_conv.conv.bias"),
                                 sd.pop(f"{p}key_conv.conv.bias")]),
                      torch.cat([a_qk, a_qk]), torch.cat([c_qk, c_qk])])
    pv = torch.stack([wv[:, 0, 0, 0], sd.pop(f"{p}value_conv.conv.bias"),
                      a_v, c_v])
    return {f"{p}wqk": torch.cat([wq, wk], 0), f"{p}pq": pq, f"{p}pv": pv}


def fuse_state_dict(state: dict) -> dict:
    """Train-form reference-keyed state (tensors or numpy) -> deploy state
    (new dict)."""
    sd = {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v)))
          for k, v in state.items()}
    sd = {k: (v.float() if torch.is_floating_point(v) else v)
          for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {}

    for p in _prefixes(sd, ".rbr_dense.0.weight"):            # RepConv
        k3, b3 = _fold(sd[f"{p}.rbr_dense.0.weight"], sd, f"{p}.rbr_dense.1")
        k1, b1 = _fold(sd[f"{p}.rbr_1x1.0.weight"], sd, f"{p}.rbr_1x1.1")
        kernel, bias = k3 + _pad_to(k1, 3), b3 + b1
        if f"{p}.rbr_identity.weight" in sd:
            cout, cin = k3.shape[:2]
            kid, bid = _fold(_identity_kernel(3, cin, cout, k3), sd,
                             f"{p}.rbr_identity")
            kernel, bias = kernel + kid, bias + bid
        out[f"{p}.rbr_reparam.weight"] = kernel
        out[f"{p}.rbr_reparam.bias"] = bias
        for sub in ("rbr_dense", "rbr_1x1", "rbr_identity"):
            _consume(sd, f"{p}.{sub}.")

    for p in _prefixes(sd, ".rbr_conv.0.conv.weight"):        # RepS_Block
        kernel = bias = None
        i = 0
        while f"{p}.rbr_conv.{i}.conv.weight" in sd:
            ki, bi = _fold(sd[f"{p}.rbr_conv.{i}.conv.weight"], sd,
                           f"{p}.rbr_conv.{i}.bn")
            kernel = ki if kernel is None else kernel + ki
            bias = bi if bias is None else bias + bi
            i += 1
        k = kernel.shape[-1]
        if f"{p}.rbr_scale.conv.weight" in sd:
            ks, bs = _fold(sd[f"{p}.rbr_scale.conv.weight"], sd,
                           f"{p}.rbr_scale.bn")
            kernel, bias = kernel + _pad_to(ks, k), bias + bs
        if f"{p}.rbr_skip.weight" in sd:
            cout, cin = kernel.shape[:2]
            kid, bid = _fold(_identity_kernel(k, cin, cout, kernel), sd,
                             f"{p}.rbr_skip")
            kernel, bias = kernel + kid, bias + bid
        out[f"{p}.reparam_conv.weight"] = kernel
        out[f"{p}.reparam_conv.bias"] = bias
        for sub in ("rbr_conv", "rbr_scale", "rbr_skip"):
            _consume(sd, f"{p}.{sub}.")

    for key in [k for k in sd if re.search(r"\.ia\.\d+\.implicit$", k)]:
        p, i = re.match(r"(.*)\.ia\.(\d+)\.implicit$", key).groups()
        w, b = sd[f"{p}.m.{i}.weight"], sd[f"{p}.m.{i}.bias"]
        b = b + w[:, :, 0, 0] @ sd[key][0, :, 0, 0]
        im = sd.pop(f"{p}.im.{i}.implicit")[0, :, 0, 0]
        out[f"{p}.m.{i}.weight"] = w * im[:, None, None, None]
        out[f"{p}.m.{i}.bias"] = b * im
        del sd[key], sd[f"{p}.m.{i}.weight"], sd[f"{p}.m.{i}.bias"]

    for p in _prefixes(sd, ".conv.weight"):                   # Conv + BN
        if f"{p}.bn.weight" not in sd:
            continue
        kernel, bias = _fold(sd.pop(f"{p}.conv.weight"), sd, f"{p}.bn")
        out[f"{p}.conv.weight"] = kernel
        out[f"{p}.conv.bias"] = bias
        for leaf in _BN_LEAVES:
            sd.pop(f"{p}.bn.{leaf}", None)

    sd.update(out)                     # folded convs + pass-through
    for p in _prefixes(sd, "query_conv.conv.weight"):         # attention
        sd.update(_pack_attention(sd, p))
    return sd
