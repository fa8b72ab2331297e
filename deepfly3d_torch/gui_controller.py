"""Qt-free state machine behind the ``df3d`` correction GUI.

A numpy-only copy of ``deepfly3d_tpu/gui_controller.py`` (``GuiController``)
driving the port's ``Core``: navigation clamping, mode gating,
mouse-to-pixel mapping, the click-drag correction flow and the error-jump
messages (the interaction flow of reference df3d/gui.py:269-322, 437-463),
testable headlessly.  The pose views render through ``Core.plot_2d``.  The
PyQt5 shell around it is ``deepfly3d_torch/gui.py``, which only builds
widgets, forwards events and blits the frames this controller renders.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

MODES = ("image", "pose", "correction")


class GuiController:
    """Holds the session state of the correction GUI.

    Methods return ``(ok, message)`` pairs where a user-facing message is
    part of the flow (the Qt layer shows non-None messages in a dialog).
    """

    def __init__(self, core):
        self.core = core
        self.img_id = 0
        self.mode = "image"
        self.joint_filter: List[int] = []    # [] = all joints
        self.joint_being_dragged: Optional[int] = None

    # ------------------------------------------------------------ navigation

    def first_image(self):
        self.display_img(0)

    def last_image(self):
        self.display_img(self.core.max_img_id)

    def prev_image(self):
        self.display_img(max(self.img_id - 1, 0))

    def next_image(self):
        self.display_img(min(self.core.max_img_id, self.img_id + 1))

    def display_img(self, img_id: int):
        # explicit raise, not assert: goto() relies on this rejecting
        # out-of-range ids, and asserts vanish under ``python -O``
        if not 0 <= img_id <= self.core.max_img_id:
            raise ValueError(f"image id {img_id} out of range")
        self.img_id = int(img_id)

    def goto(self, text: str) -> Tuple[bool, Optional[str]]:
        """The Go-button flow: parse the textbox, clamp-check, jump."""
        try:
            self.display_img(int(text))
            return True, None
        except ValueError:
            return False, "Textbox content should be an image id"

    def next_error(self) -> Tuple[bool, Optional[str]]:
        nxt = self.core.next_error(self.img_id)
        if nxt is None:
            return False, "No error remaining among next images"
        self.display_img(nxt)
        return True, None

    def prev_error(self) -> Tuple[bool, Optional[str]]:
        prv = self.core.prev_error(self.img_id)
        if prv is None:
            return False, "No error remaining among previous images"
        self.display_img(prv)
        return True, None

    # ----------------------------------------------------------------- modes

    def set_mode(self, mode: str) -> bool:
        """Pose/correction modes require 2D estimates (reference
        gui.py:283-307 gates the buttons the same way)."""
        assert mode in MODES, mode
        if mode in ("pose", "correction") and not self.core.has_pose:
            return False
        self.mode = mode
        return True

    def set_joint_filter(self, joints: Sequence[int]):
        self.joint_filter = list(joints)

    @property
    def joint_filter_enabled(self) -> bool:
        """The joint combo box is greyed out in image mode."""
        return self.mode != "image"

    def render(self, cam_id: int) -> np.ndarray:
        """The current mode's view of one camera (the display_method
        closures of reference gui.py:269-307)."""
        if self.mode == "image":
            return self.core.get_image(cam_id, self.img_id)
        if self.mode == "pose":
            return self.core.plot_2d(
                cam_id, self.img_id, joints=self.joint_filter
            )
        return self.core.plot_2d(
            cam_id, self.img_id, with_corrections=True,
            joints=self.joint_filter,
        )

    # ---------------------------------------------------------- interactions

    def view_to_pixels(
        self, x: float, y: float, view_w: float, view_h: float
    ) -> Tuple[float, float]:
        """Widget coordinates -> image pixels (reference gui.py:449-450)."""
        w, h = self.core.image_shape
        return x * w / view_w, y * h / view_h

    def press(self, cam_id: int, x: float, y: float,
              view_w: float, view_h: float) -> bool:
        """Mouse-down in correction mode: grab the nearest visible joint."""
        if self.mode != "correction":
            return False
        px, py = self.view_to_pixels(x, y, view_w, view_h)
        self.joint_being_dragged = self.core.nearest_joint(
            cam_id, self.img_id, px, py
        )
        return True

    def drag(self, cam_id: int, x: float, y: float,
             view_w: float, view_h: float) -> bool:
        """Mouse-move while dragging: write the correction through Core
        (>30 px corrections persist, reference core.py:509-544)."""
        if self.mode != "correction" or self.joint_being_dragged is None:
            return False
        px, py = self.view_to_pixels(x, y, view_w, view_h)
        self.core.move_joint(
            cam_id, self.img_id, self.joint_being_dragged, px, py
        )
        return True

    def release(self) -> bool:
        if self.joint_being_dragged is None:
            return False
        self.joint_being_dragged = None
        return True

    # --------------------------------------------------------------- actions

    def save(self):
        """The T-key / Save-button flow (fixes the reference's dead
        onclick_save_pose -> missing core.save_pose, gui.py:253-255)."""
        self.core.save()
        self.core.save_corrections()

    def auto_correct(self) -> Tuple[bool, Optional[str]]:
        """Pictorial-structures MAP correction (the checkbox the reference
        left commented out, gui.py:83-85, 300-301)."""
        if not self.core.has_calibration:
            return False, "Auto-correct needs calibration — run df3d-cli first."
        self.core.solve_pictorial()
        return True, None

    def handle_key(self, key: str) -> bool:
        """Keyboard map A/D/I/X/C/T (reference gui.py:309-322)."""
        actions = {
            "A": self.prev_image,
            "D": self.next_image,
            "I": lambda: self.set_mode("image"),
            "X": lambda: self.set_mode("pose"),
            "C": lambda: self.set_mode("correction"),
            "T": self.save,
        }
        action = actions.get(key.upper())
        if action is None:
            return False
        action()
        return True
