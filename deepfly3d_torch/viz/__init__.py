"""Rendering: 2D overlays, 3D skeleton views, result videos (a copy of
``deepfly3d_tpu/viz``; host code in numpy, cv2 and matplotlib)."""
