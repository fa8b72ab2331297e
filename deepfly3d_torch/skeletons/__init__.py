"""Skeleton models: a jax-free copy of ``deepfly3d_tpu/skeletons`` (the fly
and the Human3.6M-style human of the ``h36m`` profile)."""

from deepfly3d_torch.skeletons.skeleton import Skeleton, Tracked
from deepfly3d_torch.skeletons import fly, h36m

__all__ = ["Skeleton", "Tracked", "fly", "h36m"]
