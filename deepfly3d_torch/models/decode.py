"""Heatmap decoding and the 19->38 joint postprocess.

Counterpart of ``deepfly3d_tpu/models/decode.py`` (``decode_argmax``,
``decode_softargmax``, ``postprocess_points2d``).  The decode contract:
``points2d = (argmax_row / H, argmax_col / W)``, the plain integer argmax
over the heatmap (first index on ties), normalised by the heatmap shape; the
confidence is the unnormalised heatmap maximum.  On a card the argmax runs
in ``csrc/decode.cu``.

The soft-argmax takes its cells from that argmax (the decode kernel's
points times (H, W), which is exact: the kernel divides by tensor divisors)
and refines them in plain PyTorch on a ``window``-sized patch around each
cell, gathered once per (image, joint).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from deepfly3d_torch.ops.kernels import decode_heatmaps


def decode_argmax(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, K) heatmaps -> normalized (row, col) (N, K, 2) + conf (N, K, 1)."""
    return decode_heatmaps(heatmaps.float().contiguous())


def argmax_cells(pts: torch.Tensor, hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized argmax points (N, K, 2) of an (H, W) grid -> integer (row, col) cells."""
    return (torch.round(pts[..., 0] * hw[0]).long(), torch.round(pts[..., 1] * hw[1]).long())


def softargmax_refine(heatmaps: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                      temperature: float = 10.0, window: int = 5,
                      method: str = "parabolic") -> torch.Tensor:
    """Sub-cell (row, col) (N, K, 2), normalized, around the argmax cells (r0, c0) (N, K).

    The refinement of ``deepfly3d_tpu/models/decode.py::decode_softargmax`` on
    the ``window`` x ``window`` patch whose start is clamped to the map:
    ``"parabolic"``, the separable 3-point log-parabola through the cell
    (``log(max(h, 1e-12))``, no offset where ``denom <= 1e-8`` or at a patch
    border, the offset clipped to +-0.5), or ``"window"``, the softmax-weighted
    expectation over the patch.  The final divisions are by tensors on the
    heatmaps' device, so a card gives the CPU's IEEE quotients.
    """
    if method not in ("parabolic", "window"):
        raise ValueError(f"unknown soft-argmax method {method!r}")
    N, H, W, K = heatmaps.shape
    dev = heatmaps.device
    hm = heatmaps.float()
    half = window // 2
    rs = (r0 - half).clamp(0, H - window)
    cs = (c0 - half).clamp(0, W - window)
    offs = torch.arange(window, device=dev)
    patches = hm[torch.arange(N, device=dev)[:, None, None, None],
                 (rs[..., None] + offs)[..., :, None], (cs[..., None] + offs)[..., None, :],
                 torch.arange(K, device=dev)[None, :, None, None]]     # (N, K, window, window)
    h_t, w_t = (torch.full((), float(v), device=dev) for v in (H, W))
    if method == "window":
        probs = torch.softmax(patches.reshape(N, K, -1) * temperature, dim=-1)
        probs = probs.reshape(N, K, window, window)
        offs_f = offs.float()
        er = torch.einsum("nkrc,r->nk", probs, offs_f)
        ec = torch.einsum("nkrc,c->nk", probs, offs_f)
        return torch.stack([(rs.float() + er) / h_t, (cs.float() + ec) / w_t], dim=-1)

    pr, pc = r0 - rs, c0 - cs                  # the cell inside its (clamped) patch
    logp = torch.log(torch.clamp(patches, min=1e-12))

    def axis_offset(lp, p):
        """3-point log-parabola along one axis of the patch."""
        def at(i):
            return lp.gather(-1, i[..., None])[..., 0]

        center, prev, nxt = at(p), at((p - 1).clamp(min=0)), at((p + 1).clamp(max=window - 1))
        denom = 2.0 * center - prev - nxt
        off = torch.where(denom > 1e-8, (nxt - prev) / (2.0 * denom), 0.0)
        edge = (p == 0) | (p == window - 1)
        return torch.where(edge, 0.0, off.clamp(-0.5, 0.5))

    lp_rows = logp.gather(-1, pc[..., None, None].expand(N, K, window, 1))[..., 0]
    lp_cols = logp.gather(-2, pr[..., None, None].expand(N, K, 1, window))[..., 0, :]
    dr, dc = axis_offset(lp_rows, pr), axis_offset(lp_cols, pc)
    return torch.stack([(r0.float() + dr) / h_t, (c0.float() + dc) / w_t], dim=-1)


def decode_softargmax(heatmaps: torch.Tensor, temperature: float = 10.0, window: int = 5,
                      method: str = "parabolic",
                      argmax: Callable = decode_argmax) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sub-pixel decode: (N, H, W, K) -> refined (row, col) (N, K, 2) + conf (N, K, 1).

    The cells and the confidence (the unnormalized maximum) come from
    ``argmax`` (the decode kernel's wrapper, or its plain version), the
    refinement from ``softargmax_refine``.
    """
    pts, conf = argmax(heatmaps.float().contiguous())
    r0, c0 = argmax_cells(pts, tuple(heatmaps.shape[1:3]))
    return softargmax_refine(heatmaps, r0, c0, temperature, window, method), conf


class SoftArgmaxDecode:
    """The soft-argmax (the JAX estimator's defaults) as a decode stage: its
    cells from ``self.argmax``, which ``pipeline.plain_twin`` swaps for the
    plain decode."""

    def __init__(self, argmax: Callable = decode_argmax):
        self.argmax = argmax

    def __call__(self, heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return decode_softargmax(heatmaps, argmax=self.argmax)


def postprocess_points2d(points2d_19: np.ndarray, camera_ordering: Sequence[int],
                         num_joints: int = 38) -> np.ndarray:
    """(C, T, 19, 2) per-camera predictions -> (C, T, 38, 2) assembled pose.

    Same semantics as the JAX package (reference df3d/core.py:189-203):
    ordering positions 0-2 fill joints 0:19 and 4-6 fill 19:38, position 3
    is discarded; position 2 zeroes joints 15:, position 4 joints 19+15:;
    right-side cameras get col <- 1 - col, which turns their zero entries
    into exactly 1.0 (the flip artifact in the golden data).
    """
    points2d_19 = np.asarray(points2d_19)
    order = np.asarray(camera_ordering)
    C, T = points2d_19.shape[:2]
    side = points2d_19.shape[2]
    out = np.zeros((C, T, num_joints, 2), dtype=np.float64)
    out[order[:3], :, :side] = points2d_19[order[:3]]
    out[order[4:], :, side:] = points2d_19[order[4:]]
    out[order[2], :, 15:] = 0
    out[order[4], :, side + 15:] = 0
    for pos in (4, 5, 6):
        out[order[pos], ..., 1] = 1 - out[order[pos], ..., 1]
    return out
