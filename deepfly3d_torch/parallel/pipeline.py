"""Sharded pipeline steps over a ``mesh.Mesh``.

Counterpart of ``deepfly3d_tpu/parallel/pipeline.py``:

* the data-parallel training step (the batch split over ``data``, the
  parameters on the first entry's device, every batch norm's statistics
  over the whole batch);
* data-parallel inference (images split over ``data``): one forward per mesh
  entry, through the preprocess, bottleneck, upsample-add and decode kernels
  on a card (their plain versions on the CPU), no collective;
* frame-sharded triangulation;
* batched Levenberg-Marquardt over recordings: N bundle adjustments in one
  batched solve (``ops/bundle_adjust._lm_solve_batched``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import numpy as np
import torch
from torch.func import functional_call

from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import (HourglassNet, HourglassSpec, check_trainable,
                                              init_params, module_state)
from deepfly3d_torch.models.inference import infer_batch
from deepfly3d_torch.models.train import adam
from deepfly3d_torch.ops import geometry
from deepfly3d_torch.parallel import mesh as mesh_mod
from deepfly3d_torch.utils.devices import full_f32, resolve_device


def _on(dev: torch.device):
    """The device guard of one mesh entry's launches."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _gather(outs, mesh: mesh_mod.Mesh, axis_name: str, device) -> torch.Tensor:
    """[(entry index, output)] -> the outputs concatenated on ``device``, one
    entry per index of ``axis_name`` (entries that differ only along another
    mesh axis hold copies)."""
    keep = [out for index, out in outs
            if all(i == 0 for i, name in zip(index, mesh.axis_names) if name != axis_name)]
    return torch.cat([out.to(device) for out in keep])


# ------------------------------------------------------------- training step


class _Moments:
    """The batch-norm statistics of one step over every mesh entry's shard.

    Each entry's forward runs in a thread of its own; at each batch norm it
    posts (sum x, sum x^2, count) of its shard, meets the other entries at a
    barrier, and sums every entry's posts, copied to its device with
    ``.to`` (autograd records the copies, so one backward over the summed
    loss reaches every entry's activations).  The JAX step gets the same
    global statistics from XLA's SPMD partitioner.  ``member(rank, device)``
    is what an entry hands ``HourglassNet(..., sync=...)``; entry 0 moves
    the running statistics.
    """

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.posts = {}                       # batch norm index -> [post per entry]
        self.n = n

    def member(self, rank: int, device: torch.device):
        return _Member(self, rank, device)


class _Member:
    def __init__(self, group: _Moments, rank: int, device: torch.device):
        self.group, self.rank, self.device = group, rank, device
        self.writes = rank == 0
        self.calls = 0

    def moments(self, x: torch.Tensor):
        """(E[x], E[x^2]) per channel of an NCHW tensor over every entry's shard,
        reduced in ``x``'s dtype: float32, as ``BatchNorm`` hands it over in
        a bf16 network too."""
        posts = self.group.posts.setdefault(self.calls, [None] * self.group.n)
        self.calls += 1
        sums = torch.stack([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))])
        posts[self.rank] = (sums, x.shape[0] * x.shape[2] * x.shape[3])
        self.group.barrier.wait()
        total = sum(s.to(self.device) for s, _ in posts)
        count = sum(c for _, c in posts)
        return total[0] / count, total[1] / count


def make_sharded_train_step(spec: HourglassSpec, mesh: mesh_mod.Mesh,
                            learning_rate: float = 1e-3, axis_name: str = "data"):
    """The data-parallel training step over ``mesh``: -> (init_fn, step_fn).

    ``init_fn(rng, input_shape)`` -> (params, batch_stats, opt_state):
    ``init_params``'s trees (flax layout) on the first mesh entry's device,
    the parameters as leaf tensors that require gradients, drawn from
    ``rng`` (a ``torch.Generator`` on that device, or an int seed), and
    ``opt_state`` an ``Adam`` over them at the constant ``learning_rate``.

    ``step_fn(params, batch_stats, opt_state, images, targets)`` -> (params,
    batch_stats, opt_state, loss): images (N, h, w, 3) and targets (N, H, W,
    K) split over ``axis_name`` with ``shard_batch`` (N must divide evenly;
    numpy arrays or tensors); plain MSE over every
    stack.  Each entry runs its shard's training-mode forward in a thread,
    on a replica of the network whose parameters are copies of ``params``
    on its device, and every batch norm normalises with the statistics of
    the whole batch (``_Moments``), as the JAX step does under its SPMD
    partitioner: per-shard statistics would compute another function.  One
    backward over the summed loss gives the gradients of ``params``, summed
    over the entries; one Adam step updates ``params`` and ``batch_stats``
    in place (the same objects are returned).  Entries may repeat a device.
    A ``compute_dtype="bfloat16"`` spec trains flax's bf16 graph
    (``HourglassNet``); its statistics, parameters and loss stay float32.
    """
    check_trainable(spec)
    full_f32()
    devices = list(mesh.devices.flat)
    # one network per entry: functional_call swaps a module's tensors, so
    # threads must not share one
    replicas = [HourglassNet(spec).to(dev) for dev in devices]
    tx = adam(learning_rate)

    def init_fn(rng, input_shape: Tuple[int, int]):
        if not isinstance(rng, torch.Generator):
            rng = torch.Generator(device=devices[0]).manual_seed(int(rng))
        variables = init_params(spec, input_shape, rng, devices[0])
        params = variables["params"]
        leaves = []

        def track(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    track(v)
                else:
                    tree[k] = v.detach().requires_grad_()
                    leaves.append(tree[k])

        track(params)
        return params, variables["batch_stats"], tx(leaves)

    def step_fn(params, batch_stats, opt_state, images, targets):
        state = module_state({"params": params, "batch_stats": batch_stats})
        x_shards = mesh_mod.shard_batch(mesh, images, axis_name)
        t_shards = mesh_mod.shard_batch(mesh, targets, axis_name)
        moments = _Moments(len(devices))
        losses = [None] * len(devices)
        errors = []

        def run(rank):
            dev = devices[rank]
            try:
                with _on(dev):
                    heatmaps = functional_call(
                        replicas[rank], {k: v.to(dev) for k, v in state.items()},
                        (x_shards[rank],), {"train": True, "sync": moments.member(rank, dev)})
                    losses[rank] = ((heatmaps - t_shards[rank][None]) ** 2).sum()
            except BaseException as e:       # the other entries wait at a barrier: free them
                errors.append(e)
                moments.barrier.abort()

        threads = [threading.Thread(target=run, args=(r,)) for r in range(len(devices))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        # entries that differ only along another mesh axis hold copies of a
        # shard: counted in the sum and in the count alike, so the mean stands
        count = sum(t.numel() for t in t_shards) * spec.num_stacks
        loss = sum(l.to(devices[0]) for l in losses) / count
        opt_state.zero_grad(set_to_none=True)
        loss.backward()
        opt_state.step()
        return params, batch_stats, opt_state, loss.detach()

    return init_fn, step_fn


# ------------------------------------------------------------ inference step


def make_sharded_infer(spec: HourglassSpec, mesh: mesh_mod.Mesh, input_shape: Tuple[int, int],
                       axis_name: str = "data"):
    """Data-parallel inference: (N, H, W, 3) uint8 + (N,) flips, split over
    ``axis_name`` (N must divide evenly).

    -> ``infer(variables, images_u8, flip)`` -> (pts (N, K, 2), conf (N, K, 1))
    on the host: the per-image math of ``models.inference.infer_batch``
    (preprocess, folded hourglass, argmax decode) with one forward per mesh
    entry on its block.  ``variables`` is the tree ``load_weights`` returns;
    it is folded once per entry and the replica kept on that entry's device
    until other variables come.  Every entry's copy and launches are queued
    before any result is read back, so entries on separate cards overlap.
    """
    full_f32()
    input_shape = tuple(input_shape)
    held = {"variables": None, "nets": []}      # the replicas and what they were folded from

    def nets(variables):
        if held["variables"] is not variables:
            held.update(variables=variables, nets=[
                FoldedHourglass(fold_hourglass(variables, spec), spec).to(dev).eval()
                for dev in mesh.devices.flat])
        return held["nets"]

    def infer(variables, images_u8, flip):
        images = mesh_mod.blocks(images_u8, mesh_mod.batch_sharding(mesh, 4, axis_name))
        flips = mesh_mod.blocks(np.asarray(flip, bool),
                                mesh_mod.batch_sharding(mesh, 1, axis_name))
        outs = []
        for net, (index, dev, x), (_, _, f) in zip(nets(variables), images, flips):
            with _on(dev):
                outs.append((index, infer_batch(net, x.to(dev), f.to(dev), input_shape)))
        return tuple(_gather([(index, out[k]) for index, out in outs], mesh, axis_name, "cpu")
                     for k in range(2))

    return infer


# --------------------------------------------------- frame-sharded geometry


def make_sharded_triangulate(mesh: mesh_mod.Mesh, image_shape, axis_name: str = "data"):
    """Triangulation with the frame axis split over ``axis_name``.

    -> ``tri(points2d (C, T, J, 2), R, tvec, intr)`` -> (T, J, 3) on the
    device of ``points2d`` (the host for numpy): each entry runs
    ``geometry.triangulate`` (``"svd"``, the JAX default) on its frames; the
    DLT of every (frame, joint) is independent, so no collective.
    """
    def tri(points2d, R, tvec, intr):
        points2d = torch.as_tensor(points2d)
        p2 = mesh_mod.blocks(points2d, mesh_mod.Sharding(mesh, (None, axis_name)))
        cams = mesh_mod.replicate(mesh, (R, tvec, intr))
        outs = []
        for (index, dev, p), (R_d, t_d, K_d) in zip(p2, cams):
            with _on(dev):
                outs.append((index, geometry.triangulate(p.to(dev), R_d, t_d, K_d,
                                                         image_shape)))
        return _gather(outs, mesh, axis_name, points2d.device)

    return tri


# ------------------------------------------------- batched LM over recordings


def make_batched_calibration(image_shape, max_iters: int = 20, device="cuda"):
    """Levenberg-Marquardt over N recordings in one batched solve.

    -> ``calibrate(cams0 (B, C, 6), pts0 (B, N, 3), K (B, C, 3, 3), dist
    (B, C, 5), obs (B, C, N, 2), mask (B, C, N))`` -> (cams, pts, cost0,
    cost, iters) on ``device``, per member what its own ``_lm_solve`` gives.
    The inputs (numpy or tensors) are moved to ``device``: the card by
    default, the CPU only when asked for.
    """
    from deepfly3d_torch.ops.bundle_adjust import _lm_solve_batched

    dev = resolve_device(device)

    def calibrate(cams0, pts0, K, dist, obs, mask):
        args = [(a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a)))
                .to(dev) for a in (cams0, pts0, K, dist, obs, mask)]
        with torch.no_grad():
            return _lm_solve_batched(*args, max_iters=max_iters)

    return calibrate
