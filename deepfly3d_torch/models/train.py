"""Hourglass training: targets, the trainer, batch-norm recalibration.

Counterpart of ``deepfly3d_tpu/models/train.py``: heatmap MSE with
intermediate supervision across stacks, plus peak, maximum, worst-offender
and dominance terms so that the decoded confidences match the
heatmap-maximum contract.  Used to (re)produce the golden-parity fly
weights on the bundled recording (``deepfly3d_torch/train_fly_weights.py``)
and as the generic supervised trainer.

The network is ``models.hourglass.HourglassNet`` (plain PyTorch, cuDNN on a
card), whose parameters and batch statistics live in the module and are
updated in place; the optimiser is ``Adam``, ``torch.optim.Adam`` with
optax's defaults and a schedule read at the step count.  Where JAX runs
``steps_per_call`` steps in one ``lax.scan`` and returns the last losses,
``train_epoch`` runs them in a Python loop, keeps the losses on the device
and reads the last ones back once per call.  The device random numbers come
from a ``torch.Generator``: the batches, shifts, gains and noise are not
JAX's, so only the unaugmented full-batch steps are comparable number for
number.  The targets are numpy, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepfly3d_torch.models.hourglass import (HourglassNet, HourglassSpec, init_params,
                                              module_variables, trainable)
from deepfly3d_torch.utils.devices import full_f32, resolve_device


# ---------------------------------------------------------------- targets


def render_target_heatmaps(
    coords_rowcol: np.ndarray,     # (N, K, 2) normalized, NETWORK frame
    peak_values: np.ndarray,       # (N, K)
    known: np.ndarray,             # (N, K) bool — coords valid
    heatmap_shape: Tuple[int, int],
    sigma: float = 1.5,
    subpixel: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian target heatmaps with peak == confidence target.

    Unknown-position channels get their peak at the heatmap center: the
    decode contract only constrains their maximum value.  Returns
    (heatmaps (N, H, W, K) float32, peak_cells (N, K, 2) int).
    ``subpixel=False`` centers each Gaussian on the rounded cell;
    ``subpixel=True`` at the true position, scaled so that the value at the
    rounded cell (the discrete maximum) still equals ``peak_values``.
    """
    H, W = heatmap_shape
    N, K = peak_values.shape
    rows_f = np.where(known, coords_rowcol[..., 0] * H, float(H // 2))
    cols_f = np.where(known, coords_rowcol[..., 1] * W, float(W // 2))
    rows = np.clip(np.round(rows_f).astype(int), 0, H - 1)
    cols = np.clip(np.round(cols_f).astype(int), 0, W - 1)
    if not subpixel:
        rows_f, cols_f = rows.astype(np.float64), cols.astype(np.float64)
    yy = np.arange(H)[:, None]
    xx = np.arange(W)[None, :]
    hm = np.zeros((N, H, W, K), dtype=np.float32)
    at_cell = np.exp(-0.5 * ((rows - rows_f) ** 2 + (cols - cols_f) ** 2) / sigma**2)
    amp = peak_values / np.maximum(at_cell, 1e-12)
    for n in range(N):
        d2 = (yy[None] - rows_f[n][:, None, None]) ** 2 + (xx[None] - cols_f[n][:, None, None]) ** 2
        g = np.exp(-0.5 * d2 / sigma**2) * amp[n][:, None, None]
        hm[n] = g.transpose(1, 2, 0)
    return hm, np.stack([rows, cols], axis=-1)


def golden_training_targets(
    points2d_38: np.ndarray,       # (C, T, 38, 2) golden normalized (row, col)
    conf: np.ndarray,              # (C, T, 19, 1)
    camera_ordering: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Invert the reference postprocess to per-camera 19-channel
    network-frame targets: (coords (C, T, 19, 2), peaks (C, T, 19), known
    (C, T, 19)).  Right-side cameras' columns are re-flipped (the network
    sees mirrored images); channels whose positions the postprocess
    destroyed (middle camera, zeroed stripe channels) are unknown."""
    order = list(camera_ordering)
    C, T = points2d_38.shape[:2]
    side = points2d_38.shape[2] // 2
    coords = np.zeros((C, T, side, 2), dtype=np.float64)
    known = np.zeros((C, T, side), dtype=bool)
    for pos, cam in enumerate(order):
        if pos <= 2:
            stored = points2d_38[cam, :, :side]
            coords[cam] = stored
            known[cam] = stored.any(axis=-1)
        elif pos >= 4:
            net = points2d_38[cam, :, side:].copy()
            net[..., 1] = 1.0 - net[..., 1]   # undo the unflip
            coords[cam] = net
            known[cam] = net.any(axis=-1)     # artifacts (0, 1) -> (0, 0): unknown
        # pos == 3: all unknown
    peaks = conf[..., 0].astype(np.float64)
    return coords, peaks, known


# --------------------------------------------------------- BN recalibration


def recalibrate_batch_stats(variables, spec: HourglassSpec, images_f32, device="cuda"):
    """Replace the running batch-norm statistics with the exact statistics
    of the whole dataset: one momentum-0 training-mode pass (no gradients)
    over ``images_f32`` (N, h, w, 3), on ``device``.  Returns ``{"params":
    variables["params"], "batch_stats": <numpy>}``."""
    dev = resolve_device(device)
    full_f32()
    net = trainable(variables, dataclasses.replace(spec, bn_momentum=0.0), dev)
    with torch.no_grad():
        net(torch.as_tensor(images_f32).to(dev), train=True)
    return {"params": variables["params"], "batch_stats": module_variables(net)["batch_stats"]}


# ------------------------------------------------------------ optimiser


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable:
    """optax's schedule of the same name: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` that ends at ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    decay = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, decay)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)

    return schedule


class Adam(torch.optim.Adam):
    """``optax.adam(learning_rate, b1, b2, eps)``: torch's Adam (optax's
    formula: both bias corrections, epsilon outside the square root), where
    ``learning_rate`` may be a schedule of the step count: step t (from 0)
    runs at ``learning_rate(t)``, as optax reads it.  The count is kept in
    the parameter group, so ``state_dict`` carries it."""

    def __init__(self, params, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = learning_rate if callable(learning_rate) else (lambda count: learning_rate)
        super().__init__(params, lr=float(self.schedule(0)), betas=(b1, b2), eps=eps)
        for group in self.param_groups:
            group["count"] = 0

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = float(self.schedule(group["count"]))
        out = super().step(closure)
        for group in self.param_groups:
            group["count"] += 1
        return out


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Callable:
    """``optax.adam`` in the port's terms: -> ``tx``, with ``tx(params)``
    the optimiser state (an ``Adam`` over ``params``)."""
    return lambda params: Adam(params, learning_rate, b1, b2, eps)


# ------------------------------------------------------------------ trainer


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 2.5e-3
    steps: int = 6000
    batch_size: int = 16
    sigma: float = 1.5
    peak_loss_weight: float = 30.0
    warmup: int = 200
    seed: int = 0
    noise_scale: float = 0.0   # uniform pixel jitter (input units, ~1/255)
    freeze_bn: bool = False    # train against inference-time BN statistics
    mse_weight: float = 1.0    # heatmap-shape loss
    shift_aug: int = 0         # max random horizontal shift in HEATMAP cells
                               # per step (the input rolls 4x that)
    gain_aug: float = 0.0      # random brightness gain per step: 1 + U(-g, g)


def loss_terms(heatmaps: torch.Tensor, targets: torch.Tensor, peak_cells: torch.Tensor,
               peak_vals: torch.Tensor, peak_loss_weight: float, mse_weight: float):
    """The JAX ``loss_fn``'s loss of (S, N, H, W, K) heatmaps: -> (loss, mse,
    peak_err), 0-d tensors.  Peak-weighted MSE over every stack, then on the
    last stack the target cell's value and the map's maximum against the
    golden confidence (mean and worst offender) and the dominance (max -
    cell).  Maxima are ``amax``: a tie shares the gradient, as ``jnp.max``."""
    w = 1.0 + 20.0 * torch.clamp(targets[None], min=0.0)
    mse = torch.mean(w * (heatmaps - targets[None]) ** 2)
    last = heatmaps[-1]
    N, H, W, K = last.shape
    n_idx = torch.arange(N, device=last.device)[:, None]
    k_idx = torch.arange(K, device=last.device)[None, :]
    pred_cell = last[n_idx, peak_cells[..., 0], peak_cells[..., 1], k_idx]
    pred_max = last.amax(dim=(1, 2))                    # (N, K)
    peak_sq = (pred_cell - peak_vals) ** 2
    peak_err = torch.mean(peak_sq)
    max_sq = (pred_max - peak_vals) ** 2
    max_err = torch.mean(max_sq)
    worst = peak_sq.amax() + max_sq.amax()
    dominance = torch.mean(pred_max - pred_cell)
    loss = (mse_weight * mse + peak_loss_weight * (peak_err + max_err + worst)
            + 10.0 * dominance)
    return loss, mse, peak_err


def augment(images: torch.Tensor, targets: torch.Tensor, cells: torch.Tensor,
            rng: torch.Generator, shift_aug: int = 0, gain_aug: float = 0.0,
            noise_scale: float = 0.0):
    """One step's augmentation of a batch, drawn on the device from ``rng``
    (no read-back): -> (images, targets, cells).

    ``shift_aug`` k > 0: one horizontal shift s uniform in [-k, k] for the
    batch, the images (N, h, w, 3) rolled by 4s pixels along W, the targets
    (N, H, W, K) by s cells and the peak cells' columns moved to (c + s) mod
    W; then ``gain_aug`` g: the images times 1 + U(-g, g); then
    ``noise_scale`` a: plus U(-a, a) noise per pixel.
    """
    dev = images.device
    if shift_aug > 0:
        k = torch.randint(-shift_aug, shift_aug + 1, (), generator=rng, device=dev)
        w_in, w_hm = images.shape[2], targets.shape[2]
        images = images.index_select(2, torch.remainder(torch.arange(w_in, device=dev) - 4 * k,
                                                        w_in))
        targets = targets.index_select(2, torch.remainder(torch.arange(w_hm, device=dev) - k,
                                                          w_hm))
        cells = torch.stack([cells[..., 0], torch.remainder(cells[..., 1] + k, w_hm)], dim=-1)
    if gain_aug > 0:
        images = images * (1.0 + (2.0 * torch.rand((), generator=rng, device=dev) - 1.0) * gain_aug)
    if noise_scale > 0:
        images = images + (2.0 * torch.rand(images.shape, generator=rng, device=dev) - 1.0) \
            * noise_scale
    return images, targets, cells


def make_train_epoch(
    spec: HourglassSpec,
    tx,
    peak_loss_weight: float = 30.0,
    steps_per_call: int = 100,
    batch_size: int = 16,
    noise_scale: float = 0.0,
    freeze_bn: bool = False,
    mse_weight: float = 1.0,
    shift_aug: int = 0,
    gain_aug: float = 0.0,
):
    """-> ``train_epoch(net, opt_state, rng, images, targets, cells, peaks)``:
    ``steps_per_call`` optimiser steps with batches sampled on the device.

    ``net`` is a ``HourglassNet`` of ``spec`` and ``opt_state`` the
    optimiser ``tx`` made for its parameters (``adam``); both are updated in
    place.  ``rng`` is a ``torch.Generator`` on the data's device; images
    (N, h, w, 3), targets (N, H, W, K), cells (N, K, 2) long and peaks (N, K)
    are resident there.  A batch as large as the dataset is the whole
    dataset in order (deterministic, as in JAX).  Each step then draws its
    shift, gain and noise (``augment``).  Returns the last
    step's (loss, mse, peak_err) as floats, read back once per call.
    ``spec`` and ``tx`` keep JAX's signature: here the network and the
    optimiser made from ``tx`` come as arguments of ``train_epoch``.
    """
    del spec, tx

    def one_step(net, opt, rng, images, targets, cells, peaks):
        n = images.shape[0]
        if batch_size >= n:
            batch = (images, targets, cells, peaks)
        else:
            idx = torch.randint(0, n, (batch_size,), generator=rng, device=images.device)
            batch = (images[idx], targets[idx], cells[idx], peaks[idx])
        batch_images, batch_targets, batch_cells = augment(
            *batch[:3], rng, shift_aug, gain_aug, noise_scale)
        batch_peaks = batch[3]
        heatmaps = net(batch_images, train=not freeze_bn)
        loss, mse, peak_err = loss_terms(heatmaps, batch_targets, batch_cells, batch_peaks,
                                         peak_loss_weight, mse_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return torch.stack([loss, mse, peak_err]).detach()

    def train_epoch(net: HourglassNet, opt_state, rng, images, targets, cells, peaks):
        metrics = None
        for _ in range(steps_per_call):
            metrics = one_step(net, opt_state, rng, images, targets, cells, peaks)
        loss, mse, peak_err = metrics.tolist()
        return loss, mse, peak_err

    return train_epoch


def train_overfit(
    images_f32,                    # (N, h, w, 3) already preprocessed inputs
    target_heatmaps: np.ndarray,   # (N, H, W, K)
    peak_cells: np.ndarray,        # (N, K, 2)
    peak_vals: np.ndarray,         # (N, K)
    spec: HourglassSpec,
    cfg: TrainConfig = TrainConfig(),
    eval_fn=None,
    eval_every: int = 500,
    init_variables=None,
    keep_best: Optional[str] = None,   # eval metric to minimize
    device="cuda",
):
    """Fit the network to a fixed dataset resident on ``device`` (the card
    unless the CPU is asked for).  -> (variables as numpy, history).

    Adam under ``warmup_cosine_decay_schedule(0, lr, warmup, steps)`` with
    ``warmup = min(cfg.warmup, max(cfg.steps // 4, 1))``: the first step
    runs at lr 0, as in JAX.  Fresh weights come from ``init_params`` with a
    generator seeded by ``cfg.seed``.  ``eval_fn(variables)`` runs every
    ``eval_every`` steps; with ``keep_best`` the variables of the eval with
    the least ``keep_best`` are returned, the resumed checkpoint's own eval
    included.
    """
    dev = resolve_device(device)
    full_f32()
    images_d = torch.as_tensor(images_f32).to(dev, torch.float32)
    resumed = init_variables is not None
    if init_variables is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        init_variables = init_params(spec, tuple(images_d.shape[1:3]), gen, dev)
    net = trainable(init_variables, spec, dev)

    warmup = min(cfg.warmup, max(cfg.steps // 4, 1))
    tx = adam(warmup_cosine_decay_schedule(0.0, cfg.learning_rate, warmup, cfg.steps))
    opt_state = tx(net.parameters())

    steps_per_call = min(eval_every, cfg.steps)
    train_epoch = make_train_epoch(
        spec, tx, cfg.peak_loss_weight, steps_per_call, cfg.batch_size,
        cfg.noise_scale, cfg.freeze_bn, cfg.mse_weight, cfg.shift_aug, cfg.gain_aug,
    )
    targets_d = torch.as_tensor(target_heatmaps).to(dev, torch.float32)
    cells_d = torch.as_tensor(np.asarray(peak_cells)).to(dev, torch.long)
    peaks_d = torch.as_tensor(np.asarray(peak_vals, np.float32)).to(dev)
    rng = torch.Generator(device=dev).manual_seed(cfg.seed)

    history = []
    step = 0
    best = None
    best_vars = None
    if keep_best is not None and eval_fn is not None and resumed:
        # seed with the resumed checkpoint: a fine-tune round whose every
        # eval is worse than its start returns the start
        best_vars = module_variables(net)
        rec0 = eval_fn(best_vars)
        best = rec0[keep_best]
        print({"step": 0, **rec0}, flush=True)
    while step < cfg.steps:
        loss, mse, peak_err = train_epoch(net, opt_state, rng, images_d, targets_d, cells_d,
                                          peaks_d)
        step += steps_per_call
        rec = {"step": step, "loss": loss, "mse": mse, "peak_err": peak_err}
        if eval_fn is not None:
            variables = module_variables(net)
            rec.update(eval_fn(variables))
            if keep_best is not None and (best is None or rec[keep_best] < best):
                best = rec[keep_best]
                best_vars = variables
        history.append(rec)
        print(rec, flush=True)
    if best_vars is not None:
        return best_vars, history
    return module_variables(net), history
