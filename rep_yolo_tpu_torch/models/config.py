"""Model-config DSL: YAML graph -> static layer plan.

The port's own copy of ``rep_yolo_tpu/models/config.py``, cut to the module
set of the Rep-YOLO graphs it serves (``cfg/rep_yolo.yaml``,
``cfg/rep_yolo_tiny_test.yaml``). Same ``[from, number, module, args]``
dialect and the same channel-inference rules (reference
models/yolo.py:730-836); any other module name raises.
"""

from __future__ import annotations

import dataclasses
import math

import yaml


def make_divisible(x: float, divisor: int = 8) -> int:
    return math.ceil(x / divisor) * divisor


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    i: int                      # layer index
    f: tuple[int, ...]          # absolute source layer indices (-1: the input)
    name: str                   # module name
    args: tuple                 # static args after channel inference
    c1: int | tuple[int, ...]   # input channels
    c2: int                     # output channels
    save: bool = False          # whether a later, non-adjacent layer reads it


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    nc: int
    anchors: tuple              # (nl, na*2) in pixels
    layers: tuple[LayerSpec, ...]
    head_index: int
    ch_in: int = 3

    @property
    def nl(self) -> int:
        return len(self.anchors)

    @property
    def na(self) -> int:
        return len(self.anchors[0]) // 2


# c2 = args[0] with width_multiple; SPPCSPC also takes n at args[1].
_CH_MODULES = {"Conv", "RepConv", "SPPCSPC", "CCVA", "GSConv", "VoVGSCSP"}
_INSERT_N = {"SPPCSPC"}
_REP_MODULES = {"RepS_Block", "DER_Block"}    # raw channels, no multiple
_POOLS = {"MP", "nn.Upsample", "Upsample"}


def _as_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(_as_tuple(v) for v in x)
    return x


def parse_config(cfg: str | dict, ch: int = 3, nc: int | None = None,
                 anchors=None) -> ModelConfig:
    """Parse a model YAML (path or dict) into a static ModelConfig."""
    if isinstance(cfg, str):
        with open(cfg) as f:
            d = yaml.safe_load(f)
    else:
        d = dict(cfg)
    if nc is not None:
        d["nc"] = nc
    if anchors is not None:
        d["anchors"] = anchors

    nc = int(d["nc"])
    gd = float(d.get("depth_multiple", 1.0))
    gw = float(d.get("width_multiple", 1.0))
    anchors = _as_tuple(d["anchors"])
    no = (len(anchors[0]) // 2) * (nc + 5)
    tokens = {"nc": nc, "anchors": anchors, "None": None,
              "True": True, "False": False}

    channels: list[int] = [ch]
    layers: list[LayerSpec] = []
    save: set[int] = set()
    for i, (f, n, name, args) in enumerate(list(d["backbone"]) + list(d["head"])):
        args = [tokens.get(a, a) if isinstance(a, str) else a for a in args]
        n = max(round(n * gd), 1) if n > 1 else n
        fs = f if isinstance(f, list) else [f]
        abs_f = tuple(j if j >= 0 else i + j for j in fs)

        if name in _CH_MODULES:
            c1 = channels[f] if isinstance(f, int) else channels[fs[0]]
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            args = [c2, *args[1:]]
            if name in _INSERT_N:
                args.insert(1, n)
                n = 1
        elif name in _REP_MODULES:
            c1 = channels[f]
            c2 = args[0]
        elif name == "Concat":
            c1 = tuple(channels[j] for j in abs_f)
            c2 = sum(c1)
            args = []
        elif name == "ADD":
            c1 = tuple(channels[j] for j in abs_f)
            c2 = c1[0]
            args = []
        elif name == "IDetect":
            c1 = tuple(channels[j] for j in abs_f)
            head_anchors = args[1] if len(args) > 1 else anchors
            args = [nc, _as_tuple(head_anchors), c1]
            c2 = no
        elif name == "CA":
            # built with raw args, c2 = ch[f] (reference models/yolo.py:819)
            c1 = channels[f]
            c2 = c1
            args = [c1, *args[1:]]
        elif name in _POOLS:
            c1 = channels[f]
            c2 = c1
            if name != "MP":
                args = [args[1] if len(args) > 1 else 2]
        else:
            raise ValueError(f"unsupported module {name!r} at layer {i}")
        if n > 1 and name not in _INSERT_N:
            raise ValueError(f"n>1 for non-repeat module {name!r} at layer {i}")

        for j in abs_f:
            if j != i - 1:
                save.add(j)
        layers.append(LayerSpec(i=i, f=abs_f, name=name, args=_as_tuple(args),
                                c1=c1 if isinstance(c1, tuple) else int(c1),
                                c2=int(c2)))
        if i == 0:
            channels = []
        channels.append(c2)

    layers = [dataclasses.replace(l, save=(l.i in save)) for l in layers]
    head_anchors = layers[-1].args[1] if layers[-1].name == "IDetect" else anchors
    return ModelConfig(nc=nc, anchors=_as_tuple(head_anchors),
                       layers=tuple(layers), head_index=len(layers) - 1,
                       ch_in=ch)
