"""Pictorial-structures MAP correction over the camera graph.

Counterpart of ``deepfly3d_tpu/ops/pictorial.py``: the reconstruction of
the reference's vanished ``solve_bp_for_camnet`` (hyperparameters from
reference df3d/config.py:55-60, bone priors from skeleton_fly.py:252-261).

1. top-k heatmap peaks per (camera, joint) become 2D candidates;
2. every candidate pair of every camera pair of the side triangulates to a
   3D hypothesis (4x4 DLT through ``torch.linalg.svd``);
3. unary score: heatmap support of the nearest candidate (``alpha_heatmap``)
   minus its pixel distance (``alpha_reproj``), summed over the cameras;
4. the ``upper_bound`` strongest hypotheses per joint are kept, and the
   pairwise score is the bone-length prior between consecutive leg joints
   (``alpha_bone``);
5. exact MAP per 5-joint leg chain by max-product dynamic programming.

The JAX package vmaps one chain over (frame, leg); here every step is
batched over the chains.  Both top-k sites take a stable descending sort's
first k, so ties go to the lower index, as ``jax.lax.top_k`` breaks them.
Float32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


# chains solved at once: the pairwise scores take (L-1) x M x M floats per
# chain, 640 KB at the default upper_bound
_CHAINS_PER_STEP = 64


@dataclasses.dataclass(frozen=True)
class PictorialParams:
    num_peak: int = 10
    upper_bound: int = 200        # max 3D candidates kept per joint
    alpha_reproj: float = 30.0
    alpha_heatmap: float = 600.0
    alpha_bone: float = 10.0


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, lower index first on ties."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def top_k_peaks(heatmaps: torch.Tensor, k: int = 10):
    """(N, H, W, J) -> (coords (N, J, k, 2) normalized (row, col), scores (N, J, k))."""
    N, H, W, J = heatmaps.shape
    flat = heatmaps.permute(0, 3, 1, 2).reshape(N, J, H * W)
    scores, idx = _top_k(flat, k)
    h_t, w_t = (torch.full((), float(v), device=heatmaps.device) for v in (H, W))
    row = torch.div(idx, W, rounding_mode="floor").float() / h_t
    col = (idx % W).float() / w_t
    return torch.stack([row, col], dim=-1), scores


def _triangulate_pair(xy_a, xy_b, P_a, P_b):
    """Two-view DLT: pixel (x, y) (..., 2) in two cameras (..., 3, 4) -> (..., 3)."""
    A = torch.stack([xy_a[..., 0:1] * P_a[..., 2, :] - P_a[..., 0, :],
                     xy_a[..., 1:2] * P_a[..., 2, :] - P_a[..., 1, :],
                     xy_b[..., 0:1] * P_b[..., 2, :] - P_b[..., 0, :],
                     xy_b[..., 1:2] * P_b[..., 2, :] - P_b[..., 1, :]], dim=-2)
    X = torch.linalg.svd(A, full_matrices=True).Vh[..., -1, :]
    return X[..., :3] / X[..., 3:]


def _chain_viterbi(unary: torch.Tensor, pairwise: torch.Tensor):
    """Exact MAP on chains: unary (..., L, M), pairwise (..., L-1, M, M) (previous
    x current) -> (best index (..., L), best score (...)); argmax ties go to
    the first index."""
    L = unary.shape[-2]
    best = unary[..., 0, :]
    ptrs = []
    for l in range(1, L):
        cand = best[..., :, None] + pairwise[..., l - 1, :, :] + unary[..., l, None, :]
        ptrs.append(torch.argmax(cand, dim=-2))
        best = torch.amax(cand, dim=-2)
    idx = [torch.argmax(best, dim=-1)]
    for ptr in reversed(ptrs):
        idx.append(ptr.gather(-1, idx[-1][..., None])[..., 0])
    return torch.stack(idx[::-1], dim=-1), torch.amax(best, dim=-1)


def solve_leg_map(cand2d: torch.Tensor, cand_scores: torch.Tensor, P: torch.Tensor,
                  bone_mean: torch.Tensor, bone_std: torch.Tensor,
                  params: PictorialParams):
    """MAP 3D chains.

    cand2d (..., n_cams, L, K, 2) candidate pixels (x, y), cand_scores
    (..., n_cams, L, K) their heatmap values, P (n_cams, 3, 4), bone_mean and
    bone_std (..., L-1) -> (points3d (..., L, 3), map score (...)).
    """
    n_cams, L, K = cand2d.shape[-4:-1]
    batch = cand2d.shape[:-4]
    # 3D hypotheses of every camera pair x candidate pair, candidate-a major
    ka = torch.arange(K, device=cand2d.device).repeat_interleave(K)
    kb = torch.arange(K, device=cand2d.device).repeat(K)
    hyps = []
    for a in range(n_cams):
        for b in range(a + 1, n_cams):
            hyps.append(_triangulate_pair(cand2d[..., a, :, :, :].index_select(-2, ka),
                                          cand2d[..., b, :, :, :].index_select(-2, kb),
                                          P[a], P[b]))             # (..., L, K*K, 3)
    hyps = torch.cat(hyps, dim=-2)                               # (..., L, M_all, 3)
    M_all = hyps.shape[-2]

    # unary: heatmap support minus the distance to the nearest candidate peak
    proj = torch.einsum("cij,...lmj->...lcmi", P[:, :, :3], hyps) + P[:, None, :, 3]
    uv = proj[..., :2] / proj[..., 2:3]                          # (..., L, n_cams, M, 2)
    cands = cand2d.transpose(-4, -3)                             # (..., L, n_cams, K, 2)
    d = torch.linalg.vector_norm(uv[..., :, None, :] - cands[..., None, :, :], dim=-1)
    nearest, k_near = torch.amin(d, dim=-1), torch.argmin(d, dim=-1)   # (..., L, n_cams, M)
    hm = cand_scores.transpose(-3, -2).gather(-1, k_near)
    unary = (params.alpha_heatmap * hm - params.alpha_reproj * nearest).sum(dim=-2)

    # the strongest upper_bound hypotheses per joint
    M = min(params.upper_bound, M_all)
    unary_top, keep = _top_k(unary, M)                           # (..., L, M)
    hyps_top = hyps.gather(-2, keep[..., None].expand(keep.shape + (3,)))

    # pairwise: bone-length prior between consecutive joints
    diff = hyps_top[..., :-1, :, None, :] - hyps_top[..., 1:, None, :, :]
    length = torch.linalg.vector_norm(diff, dim=-1)              # (..., L-1, M, M)
    z = (length - bone_mean[..., None, None]) / bone_std[..., None, None]
    pairwise = -params.alpha_bone * z * z

    idx, score = _chain_viterbi(unary_top, pairwise)
    pts = hyps_top.gather(-2, idx[..., None, None].expand(batch + (L, 1, 3)))[..., 0, :]
    return pts, score


def correct_legs_map(cand2d: torch.Tensor, cand_scores: torch.Tensor, P: torch.Tensor,
                     bone_mean: torch.Tensor, bone_std: torch.Tensor,
                     params: PictorialParams = PictorialParams(), legs: int = 3,
                     leg_len: int = 5) -> torch.Tensor:
    """MAP-correct every (frame, leg) chain of one body side.

    cand2d (n_cams, T, J_side, K, 2) pixel candidates, cand_scores (n_cams,
    T, J_side, K), P (n_cams, 3, 4), bone_mean / bone_std (legs*(leg_len-1),)
    leg-major -> points3d (T, legs*leg_len, 3).
    """
    n_cams, T = cand2d.shape[:2]
    K = cand2d.shape[3]
    n = legs * leg_len
    c2 = cand2d[:, :, :n].reshape(n_cams, T, legs, leg_len, K, 2).permute(1, 2, 0, 3, 4, 5)
    sc = cand_scores[:, :, :n].reshape(n_cams, T, legs, leg_len, K).permute(1, 2, 0, 3, 4)
    c2 = c2.reshape(T * legs, n_cams, leg_len, K, 2)
    sc = sc.reshape(T * legs, n_cams, leg_len, K)
    mean = bone_mean.reshape(legs, leg_len - 1).repeat(T, 1)
    std = bone_std.reshape(legs, leg_len - 1).repeat(T, 1)
    step = _CHAINS_PER_STEP
    out = [solve_leg_map(c2[i:i + step], sc[i:i + step], P, mean[i:i + step],
                         std[i:i + step], params)[0]
           for i in range(0, T * legs, step)]
    return torch.cat(out).reshape(T, n, 3)
