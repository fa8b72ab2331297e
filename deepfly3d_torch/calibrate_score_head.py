"""Calibrate the final score head against the golden confidences through the deployed forward.

Counterpart of ``scripts/calibrate_score_head.py``, with its flags plus
``--device``:

    python -m deepfly3d_torch.calibrate_score_head CKPT_IN CKPT_OUT [--dtype bfloat16]
        [--damping D] [--alpha A] [--preprocess-dtype float32|bfloat16]
        [--hp-scope score|none] [--augment-recompress 85,75] [--augment-gain 1.04]
        [--targets-cache F.npz] [--device cuda|cpu]

The last stack's score convolution is terminal: nothing but the decode reads
it, so its weights can be refit without moving any other activation.  The
features entering it (relu of the last ``feat_bn``) are computed once for
the 105 golden images by the trainable network in eval mode at the
checkpoint's compute dtype (``HourglassNet(..., capture=True)``, after the
preprocess kernel and the deployed gain correction), and the 1x1 head is
embedded as the centre tap of a 3x3 one (``embed_score_3x3``).  Per joint a
band fit moves the peak at each golden cell to within ``BAND`` of the golden
confidence with the least change of the heatmap (the Gram metric
``compute_gram``), while a KKT active-set loop keeps every rival cell below
the chosen winner (``fit_scores``; scipy's L-BFGS-B on the host; full-map
checks on the device, ``make_device_check``).  No backward runs through the
trunk.

Up to 6 outer iterations then deploy the fit through ``pipeline.build_pipeline``
(the folded forward and its kernels) and check it with
``deepfly3d_torch/bench.verify_contract`` (and ``verify_probes`` when
augmenting): the first configuration that passes is saved; otherwise each
image set's fit targets move by the measured deployed delta times
``--damping``.  As the JAX script does: the shifted targets persist in
``--targets-cache`` under a fingerprint of the run's configuration; a run
whose clean contract passes but a probe fails leaves ``<out>.cleanonly.npz``;
a run that ends without a passing configuration exits 1; a joint whose
rival constraints cannot hold aborts the whole fit ("persistent
violations").  The checkpoint written carries ``score_ksize=3``,
``hp_scope`` and ``preprocess_dtype`` in its ``__spec__``, which both
packages' ``load_weights`` read back.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys

import numpy as np
import torch
import torch.nn.functional as F

from deepfly3d_torch.models.hourglass import HourglassSpec, load_weights, save_weights, trainable
from deepfly3d_torch.utils.devices import full_f32, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "data", "reference_df3d", "df3d_result_2d.pkl")
IMAGES = os.path.join(ROOT, "tests", "data", "reference")
NUM_CAMERAS, T_GOLD = 7, 15
MARGIN = 0.01          # cap on how far a rival is pushed below the peak
EPS_FLOOR = 3e-3       # least enforced peak-rival gap (above the deploy-vs-cache noise)
RIDGE = 1e-6           # relative ridge (kept from the JAX script, where it is unused too)
BAND = 0.0008          # |peak - target| the fit may leave
OUTERS = 6
# a winner may land within +-WINNER_DR rows / +-WINNER_DC columns of the
# golden cell: at most 0.015625 normalized error on the 64x128 grid
WINNER_DR, WINNER_DC = 1, 2


def validate_augment_qualities(aug_q):
    """JPEG quality 90 is a held-out probe transform (``bench.load_probe_frames``):
    refuse to fit on it."""
    if any(q == 90 for q in aug_q):
        raise SystemExit(
            "--augment-recompress 90 is forbidden: jpeg q90 is a held-out "
            "probe transform (bench.load_probe_frames); fitting on it "
            "would make the probe gate circular")


def validate_augment_gains(aug_g):
    """The probe gains 0.95 / 1.05 are held out: refuse to fit on them."""
    if any(abs(g - 0.95) < 1e-9 or abs(g - 1.05) < 1e-9 for g in aug_g):
        raise SystemExit(
            "--augment-gain 0.95/1.05 is forbidden: these are held-out "
            "probe transforms (bench.load_probe_frames); fit on nearby "
            "magnitudes (e.g. 0.96, 1.04) instead")


def embed_score_3x3(variables, spec: HourglassSpec):
    """(1, 1, F, K) score kernels -> (3, 3, F, K) centre-tap embeddings, and
    the spec with ``score_ksize=3``.  A 3x3 kernel is kept as it is."""
    params = dict(variables["params"])
    for i in range(spec.num_stacks):
        name = f"score{i}"
        k = np.asarray(params[name]["kernel"])
        if k.shape[:2] == (3, 3):
            continue
        emb = np.zeros((3, 3) + k.shape[2:], k.dtype)
        emb[1, 1] = k[0, 0]
        params[name] = dict(params[name], kernel=emb)
    return dict(variables, params=params), dataclasses.replace(spec, score_ksize=3)


def recompress_images(images_u8, quality):
    """OpenCV JPEG re-encode of a (N, H, W, 3) RGB uint8 stack at ``quality``."""
    import cv2

    out = np.empty_like(images_u8)
    for i, im in enumerate(images_u8):
        out[i] = cv2.imdecode(
            cv2.imencode(".jpg", im[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, int(quality)])[1],
            cv2.IMREAD_COLOR)[:, :, ::-1]
    return out


def golden_images():
    """-> (the golden pickle, the 105 golden images cam-major (105, 480, 960, 3)
    uint8, their flips (105,) bool)."""
    from deepfly3d_torch.models.inference import _read_images_threaded

    with open(GOLD, "rb") as f:
        golden = pickle.load(f)
    order = np.asarray(golden["camera_ordering"])
    flip_mask = np.zeros(NUM_CAMERAS, bool)
    flip_mask[order[4:]] = True
    paths, flips = [], []
    for cam in range(NUM_CAMERAS):
        for t in range(T_GOLD):
            paths.append(os.path.join(IMAGES, f"camera_{cam}_img_{t}.jpg"))
            flips.append(flip_mask[cam])
    return golden, _read_images_threaded(paths), np.asarray(flips)


def image_sets_for(clean, augment_qualities=(), augment_gains=()):
    """-> (image sets, per-image gain corrections): the clean images, one
    recompressed copy per quality, and one copy per gain with the deployed
    rig registration's correction (1 / the gain it estimates against the
    shipped template, 1.0 inside the dead zone)."""
    from deepfly3d_torch.ops import canonicalize

    image_sets = [clean] + [recompress_images(clean, q) for q in augment_qualities]
    corr_sets = [np.ones(len(clean), np.float32)] * len(image_sets)
    if augment_gains:
        tpl_path = canonicalize.find_template(os.path.join(ROOT, "weights", "hourglass_fly.npz"))
        if tpl_path is None:
            raise SystemExit("--augment-gain needs weights/rig_template_fly.npz (the "
                             "deployed gain correction is defined against it)")
        tpl = canonicalize.load_template(tpl_path)
        for g in augment_gains:
            gained = np.clip(clean.astype(np.float32) * g, 0, 255).astype(np.uint8)
            corr = np.ones(len(clean), np.float32)
            for cam in range(NUM_CAMERAS):
                sl = slice(cam * T_GOLD, (cam + 1) * T_GOLD)
                _, _, gain_est = canonicalize.estimate_camera_np(gained[sl], tpl, cam)
                corr[sl] = 1.0 if gain_est == 1.0 else 1.0 / gain_est
            image_sets.append(gained)
            corr_sets.append(corr)
    return image_sets, corr_sets


@torch.inference_mode()
def features(net, images_u8, flips, corr, input_shape, device):
    """One image set through the preprocess (with the gain correction) and
    the eval-mode network: -> (feat (N, h, w, F) float32 on ``device``, the
    last heatmaps (N, H, W, K) float64 numpy)."""
    from deepfly3d_torch.ops import image as image_ops

    x = image_ops.preprocess_frames(torch.from_numpy(images_u8).to(device),
                                    torch.from_numpy(flips).to(device), tuple(input_shape),
                                    net.spec.preprocess_dtype,
                                    gain=torch.from_numpy(corr).to(device))
    heatmaps, bn_out = net(x, capture=True)
    feat = torch.relu(bn_out).float().permute(0, 2, 3, 1).contiguous()
    return feat, heatmaps[-1].double().cpu().numpy()


def extract_features(variables, spec: HourglassSpec, input_shape, augment_qualities=(),
                     augment_gains=(), device="cuda"):
    """The features entering the last score conv, and the last heatmaps, for
    the 105 golden images (cam-major) and each augmented set, through the
    preprocess kernel, the deployed gain correction and the trainable network
    in eval mode at ``spec.compute_dtype`` on ``device``.

    -> (feat (S*105, h, w, F) float32 on ``device``, heat (S*105, H, W, K)
    float64, golden, image_sets: S uint8 (105, 480, 960, 3) arrays, clean first).
    """
    dev = resolve_device(device)
    full_f32()
    golden, clean, flips = golden_images()
    image_sets, corr_sets = image_sets_for(clean, augment_qualities, augment_gains)
    net = trainable(variables, spec, dev)
    feats, heats = [], []
    for imgs, corr in zip(image_sets, corr_sets):
        f_d, h = features(net, imgs, flips, corr, input_shape, dev)
        feats.append(f_d)
        heats.append(h)
    return torch.cat(feats), np.concatenate(heats), golden, image_sets


def neighborhood_rows(feat_np, n, cells):
    """Rows of the 3x3-conv design matrix: for each flat cell index in
    ``cells`` of image ``n``, the zero-padded 3x3xF neighbourhood flattened
    in kernel layout (dy, dx, f), plus the trailing bias 1."""
    N, H, W, F_ = feat_np.shape
    cells = np.atleast_1d(cells)
    rows = np.zeros((len(cells), 9 * F_ + 1))
    rows[:, -1] = 1.0
    r, c = cells // W, cells % W
    for dy in range(3):
        for dx in range(3):
            rr, cc = r + dy - 1, c + dx - 1
            ok = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
            tap = (dy * 3 + dx) * F_
            rows[ok, tap:tap + F_] = feat_np[n, rr[ok], cc[ok]]
    return rows


def golden_cells(golden, Hfull, Wfull):
    """Per (cam-major image n, channel k): the golden argmax cell as a flat
    index on the full-resolution decode grid in the network (flipped) frame,
    or -1 where the golden data pins no cell (the 19->38 assembly inverted)."""
    pts = np.asarray(golden["points2d"], np.float64)       # (7, T, 38, 2)
    order = np.asarray(golden["camera_ordering"])
    K = pts.shape[2] // 2
    cells = np.full((NUM_CAMERAS * T_GOLD, K), -1, np.int64)
    for pos, cam in enumerate(order):
        if pos == 3:
            continue                       # middle camera: discarded in 2D
        right = pos >= 4
        jbase = K if right else 0
        for t in range(T_GOLD):
            n = cam * T_GOLD + t
            for k in range(K):
                r_n, c_n = pts[cam, t, jbase + k]
                if right:
                    c_n = 1.0 - c_n        # back to the flipped frame
                if r_n == 0.0 and c_n == 0.0:
                    continue               # zeroed channel
                r, c = r_n * Hfull, c_n * Wfull
                assert abs(r - round(r)) < 1e-5 and abs(c - round(c)) < 1e-5
                cells[n, k] = int(round(r)) * Wfull + int(round(c))
    return cells


def region_cells(cell, Hfull, Wfull):
    """Flat indices of the allowed-winner region around a golden cell."""
    r, c = cell // Wfull, cell % Wfull
    rs = np.arange(max(0, r - WINNER_DR), min(Hfull, r + WINNER_DR + 1))
    cs = np.arange(max(0, c - WINNER_DC), min(Wfull, c + WINNER_DC + 1))
    return (rs[:, None] * Wfull + cs[None, :]).ravel()


def make_device_check(feat_dev: torch.Tensor, u: int):
    """The full-map evaluator of ONE joint on the features' device:
    (kern (3, 3, F, u*u), bias (u*u,)) -> the (N, h*u, w*u) heatmap as
    numpy, a float32 3x3 convolution (TF32 off) plus the bias, depth-to-space
    rearranged as the model's subpixel head."""
    full_f32()
    feat = feat_dev.permute(0, 3, 1, 2).contiguous()       # NCHW, once

    def check(kern, bias):
        w = torch.as_tensor(np.asarray(kern, np.float32)).to(feat.device).permute(3, 2, 0, 1)
        b = torch.as_tensor(np.asarray(bias, np.float32)).to(feat.device)
        with torch.inference_mode():
            h = F.conv2d(feat, w.contiguous(), padding=1) + b[:, None, None]
            n, _, hh, ww = h.shape
            h = h.permute(0, 2, 3, 1)
            if u > 1:
                h = h.reshape(n, hh, ww, u, u).permute(0, 1, 3, 2, 4).reshape(n, hh * u, ww * u)
            else:
                h = h[..., 0]
            return h.cpu().numpy()
    return check


def compute_gram(feat_dev: torch.Tensor) -> np.ndarray:
    """S = Phi^T Phi / (N H W) over every cell of every image, Phi's rows the
    3x3-neighbourhood design rows (``neighborhood_rows``' layout): float32
    products on the device (TF32 off) over chunks of 16 images, summed in
    float64 on the host, as the JAX script sums them."""
    full_f32()
    N, H, W, F_ = feat_dev.shape
    P = 9 * F_ + 1
    S = np.zeros((P, P), np.float64)
    with torch.inference_mode():
        for lo in range(0, N, 16):
            feat = feat_dev[lo:lo + 16]
            padded = F.pad(feat, (0, 0, 1, 1, 1, 1))
            taps = [padded[:, dy:dy + H, dx:dx + W, :] for dy in range(3) for dx in range(3)]
            phi = torch.cat(taps + [torch.ones(feat.shape[:3] + (1,), dtype=feat.dtype,
                                               device=feat.device)], -1).reshape(-1, P)
            S += (phi.T @ phi).double().cpu().numpy()
    return S / (N * H * W)


def fit_scores(check, feat_np, S, w0, b0, targets, gold_cells, u, alpha=0.03):
    """Per-joint minimum-heatmap-change band fit with argmax control (the
    JAX script's ``fit_scores``, the same arithmetic on the host).

    Minimizes sum_q d_q^T S d_q + alpha |d|^2 + beta * sum_n softband(a_n.(x0+d) - r_n)^2
    + beta * sum_rivals max(h_rival - ub, 0)^2 with L-BFGS-B, adding every
    violated rival cell as a constraint until the chosen winners hold.
    ``check``: ``make_device_check``; ``w0`` (3, 3, F, K*B) block-major /
    joint-minor, ``b0`` (K*B,); ``targets`` (N, K); ``gold_cells`` (N, K)
    flat full-resolution cells or -1.  A fit of fewer joints is the same
    call on their columns.  -> (w, b, the cached-feature peak residual L_inf).
    Raises RuntimeError when a joint's rival constraints cannot hold.
    """
    from scipy.optimize import minimize

    N, Hc, Wc, F_ = feat_np.shape
    B = u * u
    Hu, Wu = Hc * u, Wc * u
    K = w0.shape[-1] // B
    P = 9 * F_ + 1
    idx = np.arange(N)
    w = w0.copy()
    b = b0.copy()
    linf = 0.0
    beta = 1e6

    def rows_for(n, fullcells):
        """Block-embedded design rows for full-resolution cells of image n."""
        fullcells = np.atleast_1d(fullcells)
        r, c = fullcells // Wu, fullcells % Wu
        coarse = (r // u) * Wc + (c // u)
        q = (r % u) * u + (c % u)
        base = neighborhood_rows(feat_np, n, coarse)
        out = np.zeros((len(fullcells), B * P))
        for i in range(len(fullcells)):
            out[i, q[i] * P:(q[i] + 1) * P] = base[i]
        return out

    def unpack(x):
        Dm = x.reshape(B, P)
        kern = Dm[:, :-1].reshape(B, 3, 3, F_).transpose(1, 2, 3, 0)
        return kern, Dm[:, -1]

    dnorm_max = 0.0
    repaired_total = 0
    for j in range(K):
        ch = [q * K + j for q in range(B)]
        x0 = np.concatenate([np.concatenate([w0[..., c].ravel(), [b0[c]]]) for c in ch])
        r = targets[:, j]
        h0 = np.asarray(check(*unpack(x0)), np.float64).reshape(N, -1)

        # winners: the golden region's argmax of the current net where a
        # golden cell exists, else the current global argmax
        cells = np.empty(N, np.int64)
        repaired = 0
        for n in range(N):
            g = gold_cells[n, j]
            if g < 0:
                cells[n] = int(np.argmax(h0[n]))
            else:
                reg = region_cells(int(g), Hu, Wu)
                cells[n] = int(reg[np.argmax(h0[n, reg])])
                if int(np.argmax(h0[n])) not in set(reg.tolist()):
                    repaired += 1
        repaired_total += repaired

        A = np.concatenate([rows_for(n, cells[n]) for n in range(N)], 0)
        h0m = h0.copy()
        h0m[idx, cells] = -np.inf
        gap0 = h0[idx, cells] - h0m.max(1)
        eps_n = np.clip(0.5 * gap0, EPS_FLOOR, MARGIN)

        R_rows = np.zeros((0, B * P))
        R_ub = np.zeros((0,))
        pinned = set()
        x = x0

        def solve(R_rows, R_ub):
            def obj_grad(d):
                Dm = d.reshape(B, P)
                quad = Dm @ S + alpha * Dm
                val = float((Dm * quad).sum())
                grad = 2.0 * quad.ravel()
                e = A @ (x0 + d) - r
                soft = np.sign(e) * np.maximum(np.abs(e) - BAND, 0.0)
                val += beta * float(soft @ soft)
                grad += beta * 2.0 * (A.T @ soft)
                if len(R_ub):
                    g = R_rows @ (x0 + d) - R_ub
                    hinge = np.maximum(g, 0.0)
                    val += beta * float(hinge @ hinge)
                    grad += beta * 2.0 * (R_rows.T @ hinge)
                return val, grad
            res = minimize(obj_grad, x - x0, jac=True, method="L-BFGS-B",
                           options={"maxiter": 2000, "ftol": 1e-16, "gtol": 1e-12})
            return x0 + res.x

        for it in range(40):
            x = solve(R_rows, R_ub)
            h = np.asarray(check(*unpack(x)), np.float64).reshape(N, -1)
            hm = h.copy()
            hm[idx, cells] = -np.inf
            rival = np.argmax(hm, 1)
            viol = hm[idx, rival] > h[idx, cells] - 0.5 * eps_n
            if not viol.any():
                break
            new_rows, new_ub = [], []
            for n in np.flatnonzero(viol):
                key = (n, int(rival[n]))
                if key in pinned:
                    continue
                pinned.add(key)
                # the rival stays below the worst-case fitted peak
                new_rows.append(rows_for(n, rival[n])[0])
                new_ub.append(r[n] - BAND - eps_n[n])
            if not new_rows:
                raise RuntimeError(
                    f"joint {j}: {int(viol.sum())} persistent violations "
                    f"with {len(pinned)} pinned rivals (iter {it})")
            R_rows = np.concatenate([R_rows, np.asarray(new_rows)], 0)
            R_ub = np.concatenate([R_ub, np.asarray(new_ub)], 0)
        else:
            raise RuntimeError(f"joint {j}: argmax not stabilized ({len(pinned)} pinned rivals)")
        if pinned or repaired:
            print(f"  joint {j}: {len(pinned)} rival constraints, "
                  f"{repaired} repaired argmaxes", flush=True)
        kern_j, bias_j = unpack(x)
        for q, c in enumerate(ch):
            w[..., c] = kern_j[..., q]
            b[c] = bias_j[q]
        linf = max(linf, float(np.abs(A @ x - r).max()))
        dnorm_max = max(dnorm_max, float(np.linalg.norm(x - x0)))
    print(f"  max |d| over joints: {dnorm_max:.4f}; repaired argmaxes: {repaired_total}",
          flush=True)
    return w, b, linf


# ------------------------------------------------------- the outer loop's files


def cache_path(tcache: str) -> str:
    """``np.savez`` appends ".npz" to a path without it: the cache's path as
    written and as looked for."""
    return tcache + ".npz" if tcache and not tcache.endswith(".npz") else tcache


def cache_fingerprint(ckpt_in, dtype, hp_scope, preprocess_dtype, aug_q, aug_g, alpha,
                      damping) -> str:
    """The configuration a targets cache belongs to (the JAX script's tuple)."""
    return repr((os.path.abspath(ckpt_in), dtype, hp_scope, preprocess_dtype, sorted(aug_q),
                 sorted(aug_g), alpha, damping))


def load_targets_cache(tcache: str, fingerprint: str, fit_targets: np.ndarray,
                       targets0: np.ndarray) -> np.ndarray:
    """The cached shifted targets when ``tcache`` holds this configuration's
    of the same shape, else ``fit_targets`` (with the reason printed)."""
    if not (tcache and os.path.exists(tcache)):
        return fit_targets
    with np.load(tcache) as cached_npz:
        cached = cached_npz["fit_targets"]
        cached_fp = str(cached_npz["fingerprint"]) if "fingerprint" in cached_npz.files else ""
    if cached_fp != fingerprint:
        print(f"targets cache {tcache} fingerprint mismatch — ignored", flush=True)
        return fit_targets
    if cached.shape != fit_targets.shape:
        print(f"targets cache {tcache} shape {cached.shape} != {fit_targets.shape} — ignored",
              flush=True)
        return fit_targets
    print(f"resumed fit targets from {tcache} "
          f"(max shift {np.abs(cached - targets0).max():.5f})", flush=True)
    return cached


def cleanonly_path(ckpt_out: str) -> str:
    """Where a clean-contract passer that lost a probe is kept."""
    root, ext = os.path.splitext(ckpt_out)
    return root + ".cleanonly" + (ext or ".npz")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt_in")
    ap.add_argument("ckpt_out")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--damping", type=float, default=1.0,
                    help="fraction of the measured deploy delta fed back")
    ap.add_argument("--alpha", type=float, default=0.03,
                    help="parameter-norm weight bounding |d| (deploy noise scales with |d|)")
    ap.add_argument("--preprocess-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="the deployed preprocess dtype; the checkpoint carries it")
    ap.add_argument("--hp-scope", default="score", choices=["score", "none"],
                    help="the score convs' precision policy the checkpoint carries")
    ap.add_argument("--augment-recompress", default="",
                    help="comma-separated JPEG qualities (e.g. '85,75'): a recompressed copy "
                         "of the golden images per quality joins the fit (90 is refused)")
    ap.add_argument("--augment-gain", default="",
                    help="comma-separated gains (e.g. '1.04'): a gain -> estimate -> 1/gain "
                         "copy per gain joins the fit (0.95 / 1.05 are refused)")
    ap.add_argument("--targets-cache", default="",
                    help="npz keeping the outer loop's shifted targets; a restarted run "
                         "with the same configuration resumes from it")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from deepfly3d_torch import bench
    from deepfly3d_torch.ops import geometry
    from deepfly3d_torch.pipeline import build_pipeline

    args = parse_args(argv)
    aug_q = [int(q) for q in args.augment_recompress.split(",") if q]
    validate_augment_qualities(aug_q)
    aug_g = [float(g) for g in args.augment_gain.split(",") if g]
    validate_augment_gains(aug_g)
    dev = resolve_device(args.device)

    variables, spec0 = load_weights(args.ckpt_in)
    hp = {"hp_scope": "score" if args.hp_scope == "score" else None, "hp_precision": "highest"}
    spec0 = dataclasses.replace(spec0, compute_dtype=args.dtype,
                                preprocess_dtype=args.preprocess_dtype, **hp)
    variables, spec = embed_score_3x3(variables, spec0)
    input_shape = tuple(spec.input_shape or (256, 512))
    S = spec.num_stacks

    feat_dev, heat, golden, image_sets = extract_features(
        variables, spec, input_shape, augment_qualities=aug_q, augment_gains=aug_g, device=dev)
    n_sets = len(image_sets)
    feat_np = feat_dev.cpu().numpy()
    gold_conf = np.asarray(golden["heatmap_confidence"], np.float64)
    N, H, Wd, K = heat.shape
    u = spec.head_upsample
    targets0 = np.tile(gold_conf.reshape(NUM_CAMERAS * T_GOLD, K), (n_sets, 1))
    gcells = np.tile(golden_cells(golden, H, Wd), (n_sets, 1))
    kernel = np.asarray(variables["params"][f"score{S-1}"]["kernel"], np.float64)
    bias = np.asarray(variables["params"][f"score{S-1}"]["bias"], np.float64)

    cur_cells = heat.reshape(N, H * Wd, K).argmax(1)
    known = gcells >= 0
    agree = (cur_cells == gcells) & known
    print(f"pre-calibration: argmax agreement {int(agree.sum())}/{int(known.sum())} "
          f"golden cells", flush=True)
    cur_conf = heat.reshape(N, H * Wd, K).max(1)
    print(f"pre-calibration: conf_err={np.abs(cur_conf - targets0).max():.5f}", flush=True)

    with open(os.path.join(ROOT, "data", "calib.pkl"), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), NUM_CAMERAS, dtype=np.float32)
    order = np.asarray(golden["camera_ordering"])
    # (T, C, H, W, 3) frame stacks on the device, set 0 the golden recording
    frames_dev = [torch.from_numpy(imgs.reshape(NUM_CAMERAS, T_GOLD, *imgs.shape[1:])
                                   .transpose(1, 0, 2, 3, 4).copy()).to(dev)
                  for imgs in image_sets]
    probes_dev = None
    if aug_q or aug_g:
        try:
            probes_dev = {name: (torch.from_numpy(frames).to(dev), pt, ct)
                          for name, (frames, pt, ct) in bench.load_probe_frames().items()}
        except Exception as e:                       # noqa: BLE001  (the JAX script's fallback)
            print(f"probe construction failed ({e}); gating on the clean contract only",
                  flush=True)

    fit_targets = targets0.copy()
    tcache = cache_path(args.targets_cache)
    cache_fp = cache_fingerprint(args.ckpt_in, args.dtype, args.hp_scope, args.preprocess_dtype,
                                 aug_q, aug_g, args.alpha, args.damping)
    fit_targets = load_targets_cache(tcache, cache_fp, fit_targets, targets0)
    best = None
    best_clean = None
    check = make_device_check(feat_dev, u)
    gram = compute_gram(feat_dev)
    for outer in range(OUTERS):
        w, bvec, linf = fit_scores(check, feat_np, gram, kernel, bias, fit_targets, gcells, u,
                                   alpha=args.alpha)
        print(f"outer {outer}: cached-feature fit L_inf={linf:.6f}", flush=True)
        params = dict(variables["params"])
        params[f"score{S-1}"] = dict(params[f"score{S-1}"], kernel=w.astype(np.float32),
                                     bias=bvec.astype(np.float32))
        new_vars = dict(variables, params=params)
        pipe = build_pipeline(spec, new_vars, calib, order, input_shape, device=dev)
        pts_err, conf_err, passes = bench.verify_contract(pipe, frames_dev[0], golden)
        print(f"outer {outer}: DEPLOYED pts_err={pts_err:.5f} conf_err={conf_err:.5f} -> "
              f"{'PASS' if passes else 'fail'}", flush=True)
        clean_passes = passes
        if passes and probes_dev is not None:
            report, probes_pass = bench.verify_probes(pipe, probes_dev, golden)
            print(f"outer {outer}: probes {'PASS' if probes_pass else 'FAIL'}: {report}",
                  flush=True)
            passes = passes and probes_pass
        if (clean_passes and not passes
                and (best_clean is None or (conf_err, pts_err) < best_clean)):
            best_clean = (conf_err, pts_err)
            fallback = cleanonly_path(args.ckpt_out)
            save_weights(fallback, new_vars, spec)
            print(f"saved clean-only fallback: {fallback} (conf_err={conf_err:.5f})",
                  flush=True)
        if passes and (best is None or (conf_err, pts_err) < best[0]):
            best = ((conf_err, pts_err), new_vars)
            save_weights(args.ckpt_out, new_vars, spec)
            print(f"saved passing config: {args.ckpt_out} (conf_err={conf_err:.5f})",
                  flush=True)
        if passes:
            break
        # each image set's fit targets move by its own deployed delta
        deltas = []
        for s in range(n_sets):
            conf_dep = pipe(frames_dev[s])[2].double().cpu().numpy()
            deltas.append(conf_dep.reshape(NUM_CAMERAS * T_GOLD, K))
        conf_dep_all = np.concatenate(deltas, 0)
        fit_targets = fit_targets - args.damping * (conf_dep_all - targets0)
        if tcache:
            np.savez(tcache, fit_targets=fit_targets, fingerprint=np.str_(cache_fp))
            print(f"cached shifted targets -> {tcache}", flush=True)

    if best is None:
        print("calibration did NOT converge to a passing config", flush=True)
        sys.exit(1)

    (conf_err, _), new_vars = best
    save_weights(args.ckpt_out, new_vars, spec)
    print(f"saved: {args.ckpt_out} (dtype={args.dtype}, hp_scope={spec.hp_scope}, "
          f"score_ksize=3, deployed conf_err={conf_err:.5f})", flush=True)
    stale = cleanonly_path(args.ckpt_out)
    if os.path.exists(stale):
        os.remove(stale)
        print(f"removed stale clean-only fallback: {stale}", flush=True)
    if tcache and os.path.exists(tcache):
        os.remove(tcache)
        print(f"removed targets cache: {tcache}", flush=True)
    try:
        pipe = build_pipeline(spec, new_vars, calib, order, input_shape, device=dev)
        report, all_pass = bench.verify_probes(pipe, bench.load_probe_frames(), golden)
        print(f"held-out probes ({'PASS' if all_pass else 'FAIL'}): {report}", flush=True)
    except Exception as e:                           # noqa: BLE001  (the JAX script's fallback)
        print(f"held-out probe report unavailable: {e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
