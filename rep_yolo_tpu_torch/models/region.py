"""The int8 region: its configuration and its planner.

Port of the q8 region planner of ``rep_yolo_tpu/models/network.py``
(``DetectionNet.__call__``).

The backbone part (``st1_scale``, ``der_cm_ok``, ``cm_out_scale``, the stem
entry, the in-region MP and the DER branch): consecutive stem -> DER -> MP
-> DER spans exchange channels-last int8 maps; each producer emits int8 at
the input (st1) scale of the DER that consumes it, a sole-consumer trailing
MP is fused into the DER's cv1, any other in-region MP runs the int8 pool.

The neck part (``_FLAT_ENTRY``, ``_FLAT_PASS``, ``_req_keys``, ``flat_ok``,
``chase_scale``), on when ``Q8Region.neck`` is (the JAX package's
``NECK_Q8``, on by default): SPPCSPC, GSConv, VoVGSCSP, Conv and RepConv
layers with every scale they read run on int8 ``Q8Map``s (quantized at the
layer's entry scale where the input is float), each emitting int8 at the
entry scale of its first int8 consumer (chased through MP, upsample and
concat, which stay int8; a concat stays a list of sections), or float32
where it has none; the IDetect levels fed by int8 maps run their 1x1 in
int8. The CA / CCVA / ADD attention sandwiches stay float islands.

Every consumer outside the region reads a float32 NCHW copy, dequantized
once.

The planner is a pure function of the config, the scales and the input
size; ``DetectionNet`` runs it once per input size and publishes its
decisions as ``region_plan`` ({layer: decision string}), string for string
those of the JAX package's ``LAST_REGION_PLAN``. The TPU tiling gates that
shape those decisions (``pool_fusible``, ``pool_flat.supports``) are kept
as they are so the plans agree.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping

from rep_yolo_tpu_torch.models.config import ModelConfig
from rep_yolo_tpu_torch.nn.blocks import DERBlock
from rep_yolo_tpu_torch.ops.neck_flat import Q8Map

__all__ = ["Q8Region", "Q8Map", "Step", "RegionPlan", "plan_region"]

_LOG = logging.getLogger(__name__)

# the neck layers that may run in int8, with the conv whose input scale is
# their entry scale, and the int8 pass-through ops
_FLAT_ENTRY = {"Conv": "conv", "GSConv": "cv1/conv", "VoVGSCSP": "cv1/conv",
               "SPPCSPC": "cv1/conv", "RepConv": "rbr_reparam"}
_FLAT_PASS = {"MP", "Upsample", "nn.Upsample", "Concat"}


@dataclasses.dataclass(frozen=True)
class Q8Region:
    """The int8 region's configuration, held by the network: the
    calibration scales ({JAX scope path: scale}, ``ops.quant.calibrate``),
    the DER gate, and ``neck``: whether the neck and head run in int8 too
    (the JAX package's ``set_neck_q8``; False keeps the backbone region
    alone)."""

    scales: Mapping[str, float]
    neck: bool = True

    def select(self, c1: int) -> bool:
        # the JAX package's ``_CMAJOR_SELECT`` (c1 <= 512): the whole backbone
        return c1 <= 512

    def scale(self, key: str) -> float | None:
        s = self.scales.get(key)
        return float(s) if s is not None and s > 0.0 else None


@dataclasses.dataclass(frozen=True)
class Step:
    """How one layer runs in the region. ``kind``: "stem" (int8 stem at
    input scale ``s_in``), "der" (the 13 int8 convs at ``scales``; int8
    input when ``cm_in``), "mp_fused" (pooled by the producer's cv1),
    "mp_pool" (the int8 pool kernel), "upsample", "concat" (a list of int8
    sections), "flat" (a neck block's ``forward_flat``; float input is
    quantized at ``s_in``) or "head" (IDetect's ``forward_flat``).
    ``out_scale``: int8 output at that scale, or None for a float32 exit.
    ``raw``: the source layers read as int8 maps; the layer reads every
    other source as float32."""

    kind: str
    s_in: float | None = None
    scales: Mapping[str, float] | None = None
    cm_in: bool = False
    out_scale: float | None = None
    pool: bool = False
    raw: frozenset = frozenset()


@dataclasses.dataclass(frozen=True)
class RegionPlan:
    steps: dict[int, Step]
    strings: dict[int, str]


# -- the reference's TPU tiling gates (ops/pallas/pool_flat.py, conv_flat.py)

def _pick_tr(H: int, W: int) -> int | None:
    H2 = H // 2
    for tr in (16, 8, 4, 2, 1):
        if H2 % tr == 0 and (tr * (W // 2)) % 128 == 0 \
                and (2 * tr * W) % 128 == 0:
            return tr
    return None


def _pick_tc(C: int, HW: int, budget: int = 2 << 20) -> int | None:
    for tc in sorted((d for d in range(1, C + 1) if C % d == 0
                      and (d % 32 == 0 or d == C)), reverse=True):
        if tc * HW <= budget:
            return tc
    return None


def pool_supports(C: int, H: int, W: int) -> bool:
    """``pool_flat.supports``: the in-region MP runs the pool kernel."""
    if H % 2 or W % 2:
        return False
    if _pick_tr(H, W) is not None and C <= 512:
        return True
    return _pick_tc(C, H * W) is not None


def pool_fusible(H: int, W: int) -> bool:
    """``conv_flat.pool_fusible``: a DER's cv1 may fuse its trailing MP."""
    if H % 2 or W % 2:
        return False
    return _pick_tr(H, W) is not None or H * W <= 4096


# -- the planner --------------------------------------------------------------

def _sizes(cfg: ModelConfig, h: int, w: int) -> dict[int, tuple[int, int]]:
    """Spatial size of every layer's output at input size (h, w)."""
    size: dict[int, tuple[int, int]] = {-1: (h, w)}
    for sp in cfg.layers:
        hh, ww = size[sp.f[0]]
        a, n = sp.args, sp.name
        if n in ("Conv", "GSConv", "RepConv", "RepS_Block"):
            k = a[1] if len(a) > 1 else (3 if n == "RepConv" else 1)
            st = a[2] if len(a) > 2 else 1
            p = (a[3] if len(a) > 3 else 0) if n == "RepS_Block" else k // 2
            hh, ww = (hh + 2 * p - k) // st + 1, (ww + 2 * p - k) // st + 1
        elif n == "MP":
            hh, ww = hh // 2, ww // 2
        elif n in ("nn.Upsample", "Upsample"):
            hh, ww = hh * 2, ww * 2
        size[sp.i] = (hh, ww)
    return size


def _req_keys(sp) -> list[str]:
    """The scales a neck layer reads (all must be calibrated)."""
    pfx, n, a = f"l{sp.i}", sp.name, sp.args
    if n == "Conv":
        return [f"{pfx}/conv"]
    if n == "GSConv":
        return [f"{pfx}/cv1/conv", f"{pfx}/cv2/conv"]
    if n == "VoVGSCSP":
        ks = [f"{pfx}/cv1/conv", f"{pfx}/cv2/conv", f"{pfx}/cv3/conv"]
        for r in range(a[1] if len(a) > 1 else 1):
            g = f"{pfx}/gsb_{r}"
            ks += [f"{g}/gs1/cv1/conv", f"{g}/gs1/cv2/conv",
                   f"{g}/gs2/cv1/conv", f"{g}/gs2/cv2/conv",
                   f"{g}/shortcut/conv"]
        return ks
    if n == "SPPCSPC":
        return [f"{pfx}/cv{j}/conv" for j in range(1, 8)]
    if n == "RepConv":
        return [f"{pfx}/rbr_reparam"]
    return []


def plan_region(cfg: ModelConfig, region: Q8Region, h: int,
                w: int) -> RegionPlan:
    """The region's steps and decision strings for (h, w) input images."""
    layers = cfg.layers
    size = _sizes(cfg, h, w)
    neck = region.neck
    cons: dict[int, list[int]] = {}
    for sp in layers:
        for j in sp.f:
            cons.setdefault(sp.i - 1 if j == -1 else j, []).append(sp.i)

    def srcs(sp) -> list[int]:
        return [sp.i - 1 if j == -1 else j for j in sp.f]

    def src(sp) -> int:
        return srcs(sp)[0]

    def st1_scale(i: int) -> float | None:
        return region.scale(f"l{i}/stage1/reparam_conv")

    def flat_ok(sp) -> bool:
        n, a = sp.name, sp.args
        if not neck or n not in _FLAT_ENTRY:
            return False
        k = a[1] if len(a) > 1 else (3 if n == "RepConv" else 1)
        st = a[2] if len(a) > 2 else 1
        if n == "Conv" and (k not in (1, 3) or st != 1):
            return False
        if n == "GSConv" and (k, st) not in ((1, 1), (3, 1), (3, 2)):
            return False
        if n == "RepConv" and (k != 3 or st != 1):
            return False
        return all(region.scale(key) is not None for key in _req_keys(sp))

    def chase_scale(i: int, depth: int = 0) -> float | None:
        """The scale to emit layer i's int8 output at: the entry scale of
        its first int8 consumer, chased through the pass-through ops."""
        if depth > 8:
            return None
        for k in cons.get(i, []):
            sp2 = layers[k]
            n2 = sp2.name
            if n2 in _FLAT_PASS:
                s = chase_scale(sp2.i, depth + 1)
            elif n2 == "IDetect":
                s = region.scale(f"l{sp2.i}/m_{srcs(sp2).index(i)}")
            elif flat_ok(sp2):
                s = region.scale(f"l{sp2.i}/{_FLAT_ENTRY[n2]}")
            else:
                continue
            if s is not None:
                return s
        return None

    def der_cm_ok(sp, hh: int, ww: int) -> bool:
        if sp.name != "DER_Block" or not isinstance(sp.c1, int):
            return False
        if not region.select(sp.c1):
            return False
        if st1_scale(sp.i) is None:
            # gate-selected but uncalibrated: without this warning the
            # region silently ends here
            _LOG.warning(
                "q8 region: DER l%d (c1=%d @%dx%d) passes the select gate "
                "but has no st1 calibration scale — layer exits the region",
                sp.i, sp.c1, hh, ww)
            return False
        return True

    def cm_out_scale(i: int, hh: int, ww: int):
        """(scale, target layer, MP layer or None) to emit layer i's int8
        output at, else None (exit the region in float)."""
        for k in cons.get(i, []):
            sp = layers[k]
            if sp.name == "MP":
                for k2 in cons.get(k, []):
                    sp2 = layers[k2]
                    if der_cm_ok(sp2, hh // 2, ww // 2):
                        return st1_scale(sp2.i), sp2.i, k
            elif der_cm_ok(sp, hh, ww):
                return st1_scale(sp.i), sp.i, None
        return None

    cm: dict[int, tuple[float, int, int, int]] = {}   # i -> (s, h, w, tgt)
    flat: dict[int, str] = {}      # neck outputs: "map" (a Q8Map) or "list"
    pooled: set[int] = set()
    steps: dict[int, Step] = {}
    plan: dict[int, str] = {}
    for sp in layers:
        i, n, a = sp.i, sp.name, sp.args
        in_h, in_w = size[sp.f[0]]
        flat_keep = neck and (n in _FLAT_PASS or n == "IDetect"
                              or flat_ok(sp))
        # what this layer reads of each source: its int8 map, or float
        seen = {j: flat[j] if j in flat and flat_keep else "float"
                for j in srcs(sp)}
        if n == "Concat" and neck and all(v != "float"
                                          for v in seen.values()):
            steps[i] = Step("concat", raw=frozenset(seen))
            flat[i] = "list"
            plan[i] = "in-region concat (unmaterialized)"
        elif n == "MP" and neck and seen[src(sp)] == "map":
            j = src(sp)
            steps[i] = Step("mp_pool", raw=frozenset((j,)))
            flat[i] = "map"
            plan[i] = ("in-region flat int8 pool (neck)"
                       if pool_supports(layers[j].c2, *size[j])
                       else "in-region pool via max_pool_cm (neck)")
        elif n == "MP":
            j = src(sp)
            if j in pooled:
                steps[i] = Step("mp_fused", raw=frozenset((j,)))
                cm[i] = cm[j]
                plan[i] = "MP fused into producer cv1 epilogue"
            elif j in cm:
                s, hh, ww, tgt = cm[j]
                c = layers[j].c2
                # K6 pools any even map; the TPU gate only picks the string
                steps[i] = Step("mp_pool", raw=frozenset((j,)))
                if pool_supports(c, hh, ww):
                    plan[i] = "in-region flat int8 pool"
                else:
                    plan[i] = ("in-region pool via max_pool_cm (pool_flat "
                               f"unsupported for C={c} {hh}x{ww}: relayout "
                               "cost)")
                cm[i] = (s, hh // 2, ww // 2, tgt)
        elif n in ("nn.Upsample", "Upsample") and neck \
                and seen[src(sp)] == "map":
            steps[i] = Step("upsample", raw=frozenset((src(sp),)))
            flat[i] = "map"
            plan[i] = "in-region flat upsample"
        elif (n == "RepS_Block" and isinstance(sp.c1, int) and sp.c1 <= 4
              and (a[1] if len(a) > 1 else 3) == 3
              and (a[2] if len(a) > 2 else 1) == 2):
            h2, w2 = in_h // 2, in_w // 2
            out = cm_out_scale(i, h2, w2)
            out_s = out[0] if out is not None else None
            s_in = region.scale(f"l{i}/reparam_conv")
            p = a[3] if len(a) > 3 else 0
            if (out_s is not None and s_in is not None and p == 1
                    and in_h % 2 == 0 and in_w % 2 == 0):
                steps[i] = Step("stem", s_in=s_in, out_scale=out_s)
                cm[i] = (out_s, h2, w2, out[1])
                plan[i] = ("region entry: fused flat int8 s2d stem -> int8 "
                           f"@ st1(l{out[1]})")
            elif out_s is not None:
                plan[i] = ("stem fast path declined (stem conv "
                           "uncalibrated): NHWC bf16")
                _LOG.warning("q8 region: stem l%d has a cm successor but "
                             "its own input scale is missing — region "
                             "starts later", i)
            else:
                plan[i] = "stem: no cm-capable successor"
        elif n == "DER_Block":
            j = src(sp)
            hh, ww = cm[j][1:3] if j in cm else (in_h, in_w)
            ok = der_cm_ok(sp, hh, ww)
            use_cm = j in cm and ok and cm[j][3] == i
            out = cm_out_scale(i, hh, ww) if ok else None
            out_s = out[0] if out is not None else None
            fuse_pool = (out is not None and out[2] is not None
                         and set(cons.get(i, ())) == {out[2]}
                         and pool_fusible(hh, ww))
            sc = (DERBlock.q8_scales(region.scales, f"l{i}")
                  if isinstance(sp.c1, int) and region.select(sp.c1)
                  else None)
            if use_cm and sc is None:
                raise ValueError(
                    f"DER l{i} takes int8 but its int8 path declined "
                    "(missing calibration scales or gate mismatch)")
            if sc is not None:
                steps[i] = Step("der", scales=sc, cm_in=use_cm,
                                out_scale=out_s,
                                pool=fuse_pool and out_s is not None,
                                raw=frozenset((j,) if use_cm else ()))
            src_s = "int8 in" if use_cm else "NHWC in"
            if out_s is not None and sc is not None:
                if fuse_pool:
                    cm[i] = (out_s, hh // 2, ww // 2, out[1])
                    pooled.add(i)
                else:
                    cm[i] = (out_s, hh, ww, out[1])
                plan[i] = (f"in-region DER (c1={sp.c1} @{hh}x{ww}, {src_s})"
                           f" -> int8 @ st1(l{out[1]})"
                           + (f" (MP l{out[2]} fused into cv1)"
                              if fuse_pool else ""))
            else:
                if ok and out_s is not None:
                    _LOG.warning(
                        "q8 region: DER l%d was planned in-region but its "
                        "fast path declined (incomplete calibration) — "
                        "exits in NHWC bf16", i)
                plan[i] = (f"DER (c1={sp.c1} @{hh}x{ww}, {src_s}) -> "
                           + ("NHWC bf16 out (no cm successor)" if ok
                              else "NHWC out (select gate or calibration "
                                   "declined)"))
        elif flat_ok(sp):
            out_s = chase_scale(i)
            if seen[src(sp)] != "float":
                s_in, entry = None, ""
            else:
                s_in = region.scale(f"l{i}/{_FLAT_ENTRY[n]}")
                entry = "neck entry quantize; "
            steps[i] = Step("flat", s_in=s_in, out_scale=out_s,
                            raw=frozenset(j for j, v in seen.items()
                                          if v != "float"))
            if out_s is not None:
                flat[i] = "map"
            plan[i] = (entry + f"in-region {n} -> "
                       + ("int8" if out_s is not None else "NHWC exit"))
        elif n == "IDetect" and any(v == "map" for v in seen.values()):
            steps[i] = Step("head", raw=frozenset(
                j for j, v in seen.items() if v == "map"))
    return RegionPlan(steps, plan)
