"""Skeleton models: a jax-free copy of ``deepfly3d_tpu/skeletons`` (the fly).

The H3.6M skeleton comes with the ``h36m`` profile (ROADMAP.md Queue 1).
"""

from deepfly3d_torch.skeletons.skeleton import Skeleton, Tracked
from deepfly3d_torch.skeletons import fly

__all__ = ["Skeleton", "Tracked", "fly"]
