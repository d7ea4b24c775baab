"""Training state and the train step (port of ``rep_yolo_tpu/train/trainer.py``).

One step: the augmentation (``augment_fn``, drawing from the state's augment
generator) or the no-augment input normalization, the train-form forward
(batch statistics, running averages moved, dropout from the state's
generator), the simOTA or classic loss times the batch, autograd, the
3-group SGD (nesterov) or Adam update with warmup and one-cycle, and the
EMA of the parameters and BN statistics. With ``accumulate`` the gradients are summed
over micro-batches and the optimizer and EMA apply every ``accum_target``
of them; the iteration counter advances every micro-batch, as in the JAX
package. The state is updated in place (the JAX step returns a new one).

Not ported yet, and refused: multi-scale (``resize_to``), mixed precision,
the aux-head loss and the device mesh.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from rep_yolo_tpu_torch.data.augment import identity_batch
from rep_yolo_tpu_torch.train import optim as optim_lib
from rep_yolo_tpu_torch.train.ema import init_ema, update_ema
from rep_yolo_tpu_torch.train.loss import (LossConfig, compute_loss,
                                           compute_loss_ota)


@dataclasses.dataclass
class TrainState:
    """``model`` holds the parameters and BN statistics; the rest is keyed
    like ``model.net``'s parameters (``momentum``, ``second``, ``acc``) or
    state dict (``ema``)."""
    model: object                      # models.model.RepYOLO, train form
    groups: dict[str, int]
    momentum: dict[str, torch.Tensor]  # SGD buffer / Adam m
    second: dict[str, torch.Tensor]    # Adam v
    step: int                          # global iteration ni
    ema: dict[str, torch.Tensor]
    ema_updates: int
    generator: torch.Generator         # dropout masks
    acc: dict[str, torch.Tensor]       # accumulated gradient
    acc_n: int = 0
    aug_generator: torch.Generator | None = None   # augmentation draws

    @property
    def params(self) -> dict[str, torch.nn.Parameter]:
        return dict(self.model.net.named_parameters())


def create_train_state(model, seed: int = 0) -> TrainState:
    """Zero optimizer buffers, the EMA at the current weights, a dropout
    generator seeded with ``seed`` on the model's device and an augment
    generator there seeded with ``seed + 2**32`` (no run's two streams share
    a seed)."""
    net = model.net
    if getattr(model, "deploy", False):
        raise ValueError("training needs the train-form model")
    params = dict(net.named_parameters())
    gen = torch.Generator(device=model.device)
    net.set_generator(gen)
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
    state = TrainState(model=model, groups=optim_lib.param_groups(net),
                       momentum=zeros(), second=zeros(), step=0,
                       ema=init_ema(net), ema_updates=0, generator=gen,
                       acc=zeros(), acc_n=0,
                       aug_generator=torch.Generator(device=model.device))
    seed_generators(state, seed)
    return state


def seed_generators(state: TrainState, seed: int) -> None:
    """Seed the dropout generator with ``seed`` and the augment generator
    with ``seed + 2**32``, as ``create_train_state`` does."""
    state.generator.manual_seed(seed)
    state.aug_generator.manual_seed(seed + 2 ** 32)


def make_train_step(model, loss_cfg: LossConfig,
                    opt_cfg: optim_lib.OptimConfig, img_size: int,
                    loss_mode: str = "ota", resize_to: int | None = None,
                    mixed_precision: bool = False, accumulate: bool = False,
                    augment_fn=None):
    """The train step ``step(state, images, hw, labels, mask[,
    accum_target]) -> components`` ({box, obj, cls, total} tensors).
    ``step.grads(state, images, hw, labels, mask)`` is its forward and
    backward alone: (grads keyed like the parameters, components); it moves
    the BN statistics and draws dropout masks, and applies nothing.

    images (B, S, S, 3) uint8 canvases, hw (B, 2) content sizes, labels
    (B, M, 5) normalized to the content, mask (B, M), on the model's
    device. ``loss_mode``: 'ota' (default) or 'classic'. ``augment_fn(images,
    hw, labels, mask, generator) -> data.augment.Batch`` augments in float32
    on the device, drawing from ``state.aug_generator``; its result is cast
    to the parameters' dtype. Without it, ``identity_batch``."""
    if loss_mode not in ("ota", "classic"):
        raise NotImplementedError(f"loss_mode {loss_mode!r} is not ported "
                                  f"yet")
    if resize_to is not None and resize_to != img_size:
        raise NotImplementedError("multi-scale training is not ported yet")
    if mixed_precision:
        raise NotImplementedError("mixed precision is not ported yet")
    anchors_grid = model.anchors_grid
    strides = model.strides

    def grads_of(state: TrainState, images, hw, labels, mask):
        """(grads of total * B, components); the profiler ranges name the
        forward, loss and backward of the step."""
        net = state.model.net
        net.train()
        params = state.params
        # labels and images in the parameters' dtype (float64 in a test), as
        # the JAX step promotes them
        dt = next(iter(params.values())).dtype
        if augment_fn is not None:
            with record_function("train/augment"):
                images, labels, mask = augment_fn(images, hw, labels, mask,
                                                  state.aug_generator)
                labels = labels.to(dt)
        with record_function("train/forward"):
            if augment_fn is None:
                images, labels = identity_batch(images, hw.to(dt),
                                                labels.to(dt))
            preds = net(images.to(dt))
        with record_function("train/loss"):
            if loss_mode == "ota":
                loss, comps = compute_loss_ota(preds, labels, mask,
                                               anchors_grid, strides,
                                               img_size, loss_cfg)
            else:
                loss, comps = compute_loss(preds, labels, mask, anchors_grid,
                                           loss_cfg)
        with record_function("train/backward"):
            g = torch.autograd.grad(loss, list(params.values()))
        comps = {k: v.detach() for k, v in comps.items()}
        return dict(zip(params, g)), comps

    def apply(state: TrainState, grads) -> None:
        with record_function("train/optimizer"):
            optim_lib.apply_updates(state.params, grads, state.momentum,
                                    state.second, state.groups, state.step,
                                    opt_cfg)
            state.ema_updates += 1
            update_ema(state.ema, state.model.net, state.ema_updates)

    def train_step(state: TrainState, images, hw, labels, mask):
        grads, comps = grads_of(state, images, hw, labels, mask)
        apply(state, grads)
        state.step += 1
        return comps

    train_step.grads = grads_of

    def train_step_accum(state: TrainState, images, hw, labels, mask,
                         accum_target: int):
        grads, comps = grads_of(state, images, hw, labels, mask)
        with torch.no_grad():
            torch._foreach_add_(list(state.acc.values()),
                                [grads[k] for k in state.acc])
        state.acc_n += 1
        if state.acc_n >= accum_target:
            apply(state, state.acc)
            with torch.no_grad():
                torch._foreach_zero_(list(state.acc.values()))
            state.acc_n = 0
        state.step += 1
        return comps

    train_step_accum.grads = grads_of
    return train_step_accum if accumulate else train_step


def accum_target_for(ni: int, nw: int, final: int) -> int:
    """Warmup accumulate ramp (reference train.py:357): 1 -> ``final`` over
    the ``nw`` warmup iterations, then ``final``."""
    if final <= 1 or ni >= nw:
        return max(final, 1)
    return max(1, round(1 + (final - 1) * ni / max(nw, 1)))
