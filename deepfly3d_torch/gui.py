"""The ``df3d`` PyQt5 correction GUI over the port's ``Core``.

Counterpart of ``deepfly3d_tpu/gui.py``, in its structure and names: a 2x3
camera grid with Image / Pose / Correction modes, click-drag manual joint
correction, keyboard navigation (A/D/I/X/C/T), jump-to-error buttons, Save
and Auto-correct (the pictorial-structures MAP, ``Core.solve_pictorial``).

All state and decisions live in the Qt-free ``gui_controller.GuiController``
(navigation clamping, mode gating, the drag-correction flow, coordinate
mapping, the key map); this module only builds widgets, forwards events,
and blits the controller's rendered frames.

Device split, as in ``Core``: the network behind Auto-correct runs on
``device`` (default ``"cuda"``, raising without a card; ``--device cpu``
runs the kernels' plain versions), while loading, drawing, correcting and
saving run on the host whatever the device.

PyQt5 is optional at import time — the module raises a clear error only
when the GUI is actually launched without PyQt5 installed.

    python -m deepfly3d_torch.gui FOLDER [NUM_IMAGES_MAX] [--device cpu]
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

try:
    from PyQt5 import QtWidgets as QW
    from PyQt5.QtCore import QEvent, Qt
    from PyQt5.QtGui import QImage, QPixmap

    HAS_PYQT = True
except ImportError:  # headless environments
    HAS_PYQT = False
    QW = None

USAGE = ("Usage: python -m deepfly3d_torch.gui <input_folder> [num_images_max] "
         "[--device DEVICE]")


def parse_cli_args(argv):
    """[input_folder] [num_images_max] [--device DEVICE] after the program name.

    The positional rule is the JAX GUI's; ``--device X`` may stand anywhere
    after the program name and is taken out before it."""
    argv = list(argv)
    device = "cuda"
    if "--device" in argv[1:]:
        i = argv.index("--device", 1)
        if i + 1 >= len(argv):
            raise SystemExit(f"--device needs a value. {USAGE}")
        device = argv[i + 1]
        del argv[i:i + 2]
    args = {"input_folder": None, "num_images_max": None, "device": device}
    if len(argv) > 1:
        args["input_folder"] = argv[1]
    if len(argv) > 2:
        try:
            args["num_images_max"] = int(argv[2])
        except ValueError:
            pass
    return args


def main():
    if not HAS_PYQT:
        raise SystemExit(
            "The df3d GUI requires PyQt5 (pip install PyQt5). "
            "The processing pipeline itself is available via "
            "python -m deepfly3d_torch.cli."
        )
    cli_args = parse_cli_args(sys.argv)
    input_folder = cli_args["input_folder"]
    if not input_folder:
        raise SystemExit(USAGE)
    if not (glob.glob(os.path.join(input_folder + "_df3d", "df3d_result*.pkl"))
            or glob.glob(os.path.join(input_folder, "df3d_result*.pkl"))):
        raise SystemExit(
            f"Before running the GUI, run python -m deepfly3d_torch.cli on folder "
            f"{input_folder} first and generate a df3d_result file"
        )
    app = QW.QApplication([])
    window = DeepflyGUI()
    window.setup(**cli_args)
    window.set_width(app.desktop().size().width())
    window.show()
    app.exec_()


if HAS_PYQT:

    class DeepflyGUI(QW.QWidget):
        def __init__(self):
            super().__init__()
            self.core = None
            self.ctl = None

        # ------------------------------------------------------------ setup

        def setup(self, input_folder=None, num_images_max=None, device="cuda"):
            from deepfly3d_torch.core import Core
            from deepfly3d_torch.gui_controller import GuiController

            if not input_folder:
                input_folder = self.prompt_for_directory()
            self.core = Core(input_folder, None, num_images_max, None, device=device)
            self.ctl = GuiController(self.core)
            self.setup_layout()
            self.onclick_image_mode()

        def set_width(self, width):
            hw_ratio = self.core.image_shape[0] * 1.2 / self.core.image_shape[1]
            self.resize(width, int(width / hw_ratio))

        def setup_layout(self):
            def mb(text, on_click, checkable=False):
                b = QW.QPushButton(text, self)
                b.setMaximumWidth(
                    b.fontMetrics().boundingRect(text).width() + 27
                )
                b.clicked.connect(on_click)
                b.setCheckable(checkable)
                return b

            self.button_first = mb("<<", self.onclick_first_image)
            self.button_prev = mb("<", self.onclick_prev_image)
            self.button_next = mb(">", self.onclick_next_image)
            self.button_last = mb(">>", self.onclick_last_image)
            self.button_prev_err = mb("< previous error", self.onclick_prev_error)
            self.button_next_err = mb("next error >", self.onclick_next_error)
            self.button_save = mb("Save", self.onclick_save)
            # the pictorial-structures MAP (Core.solve_pictorial): the
            # network on the core's device, the MAP on the host
            self.button_auto_correct = mb(
                "Auto-correct", self.onclick_auto_correct
            )
            self.button_image_mode = mb("Image", self.onclick_image_mode, True)
            self.button_pose_mode = mb("Pose", self.onclick_pose_mode, True)
            self.button_correction_mode = mb(
                "Correction", self.onclick_correction_mode, True
            )
            button_go = mb("Go", self.onclick_goto_img)

            self.textbox_img_id = QW.QLineEdit(str(self.ctl.img_id), self)
            self.textbox_img_id.setFixedWidth(100)

            self.combo_joint_id = QW.QComboBox(self)
            self.combo_joint_id.addItem("View all joints", [])
            for i in range(self.core.number_of_joints):
                self.combo_joint_id.addItem(f"View joint {i}", [i])
            self.combo_joint_id.activated.connect(self.update_frame)

            def image_view(cam_id):
                iv = QW.QLabel()
                iv.setScaledContents(True)
                iv.cam_id = cam_id
                iv.installEventFilter(self)
                return iv

            top = [image_view(c) for c in (0, 1, 2)]
            bottom = [image_view(c) for c in (4, 5, 6)]
            self.image_views = top + bottom

            row_top = QW.QHBoxLayout()
            row_bottom = QW.QHBoxLayout()
            for iv in top:
                row_top.addWidget(iv)
            for iv in bottom:
                row_bottom.addWidget(iv)

            modes = QW.QHBoxLayout()
            modes.setAlignment(Qt.AlignRight)
            modes.addWidget(self.button_save)
            modes.addWidget(self.button_auto_correct)
            modes.addStretch()
            modes.addWidget(self.button_image_mode)
            modes.addWidget(self.button_pose_mode)
            modes.addWidget(self.button_correction_mode)

            nav = QW.QHBoxLayout()
            for w in (
                self.button_first, self.button_prev, self.button_next,
                self.button_last, self.textbox_img_id, button_go,
            ):
                nav.addWidget(w)
            nav.addStretch()
            nav.addWidget(self.button_prev_err)
            nav.addWidget(self.button_next_err)
            nav.addStretch()
            nav.addWidget(self.combo_joint_id)

            layout = QW.QVBoxLayout()
            layout.addLayout(modes)
            layout.addLayout(row_top)
            layout.addLayout(row_bottom)
            layout.addLayout(nav)
            self.setLayout(layout)
            self.setWindowTitle(self.core.input_folder)

        # ------------------------------------------------------- navigation

        def onclick_first_image(self):
            self.ctl.first_image()
            self.refresh()

        def onclick_last_image(self):
            self.ctl.last_image()
            self.refresh()

        def onclick_prev_image(self):
            self.ctl.prev_image()
            self.refresh()

        def onclick_next_image(self):
            self.ctl.next_image()
            self.refresh()

        def onclick_prev_error(self):
            ok, msg = self.ctl.prev_error()
            if ok:
                self.refresh()
            else:
                self.display_error_message(msg)

        def onclick_next_error(self):
            ok, msg = self.ctl.next_error()
            if ok:
                self.refresh()
            else:
                self.display_error_message(msg)

        def onclick_goto_img(self):
            ok, msg = self.ctl.goto(self.textbox_img_id.text())
            if ok:
                self.refresh()
                self.setFocus()
            else:
                self.display_error_message(msg)
                self.textbox_img_id.setText(str(self.ctl.img_id))

        def onclick_save(self):
            self.ctl.save()

        def onclick_auto_correct(self):
            """Pictorial-structures MAP over the camera graph; corrected
            leg keypoints are written into the session's points2d."""
            ok, msg = self.ctl.auto_correct()
            if ok:
                self.update_frame()
            else:
                self.display_error_message(msg)

        # ------------------------------------------------------------ modes

        def uncheck_mode_buttons(self):
            for b in (
                self.button_image_mode,
                self.button_pose_mode,
                self.button_correction_mode,
            ):
                b.setChecked(False)

        def _enter_mode(self, mode, button):
            if not self.ctl.set_mode(mode):
                return
            self.uncheck_mode_buttons()
            button.setChecked(True)
            self.combo_joint_id.setEnabled(self.ctl.joint_filter_enabled)
            self.update_frame()

        def onclick_image_mode(self):
            self._enter_mode("image", self.button_image_mode)

        def onclick_pose_mode(self):
            self._enter_mode("pose", self.button_pose_mode)

        def onclick_correction_mode(self):
            self._enter_mode("correction", self.button_correction_mode)

        # ---------------------------------------------------------- display

        def refresh(self):
            self.textbox_img_id.setText(str(self.ctl.img_id))
            self.update_frame()

        def update_frame(self, *_):
            self.ctl.set_joint_filter(self.combo_joint_id.currentData() or [])
            for iv in self.image_views:
                self._set_image(iv, self.ctl.render(iv.cam_id))

        def _set_image(self, image_view, image: np.ndarray):
            image = np.ascontiguousarray(image)
            h, w, _ = image.shape
            qimg = QImage(image.data, w, h, 3 * w, QImage.Format_RGB888)
            image_view.setPixmap(QPixmap.fromImage(qimg))

        def display_error_message(self, message):
            QW.QMessageBox.warning(self, "Error", message)

        def prompt_for_directory(self):
            return str(
                QW.QFileDialog.getExistingDirectory(
                    self,
                    directory="./",
                    caption="Select Directory",
                    options=QW.QFileDialog.DontUseNativeDialog,
                )
            )

        # ---------------------------------------------------- interactions

        def _sync_mode_buttons(self):
            self.uncheck_mode_buttons()
            {
                "image": self.button_image_mode,
                "pose": self.button_pose_mode,
                "correction": self.button_correction_mode,
            }[self.ctl.mode].setChecked(True)
            self.combo_joint_id.setEnabled(self.ctl.joint_filter_enabled)

        def keyPressEvent(self, event):
            # keycode translation only — the key->action map itself lives
            # solely in GuiController.handle_key
            letter = {
                Qt.Key_A: "A", Qt.Key_D: "D", Qt.Key_I: "I",
                Qt.Key_X: "X", Qt.Key_C: "C", Qt.Key_T: "T",
            }.get(event.key())
            if letter and self.ctl.handle_key(letter):
                self._sync_mode_buttons()
                self.refresh()

        def eventFilter(self, source, event):
            """Click-drag joint correction; the press/drag/release flow is
            GuiController's."""
            cam_id = getattr(source, "cam_id", None)
            if cam_id is None:
                return super().eventFilter(source, event)
            if event.type() == QEvent.MouseButtonPress:
                if self.ctl.press(cam_id, event.pos().x(), event.pos().y(),
                                  source.width(), source.height()):
                    return True
            elif event.type() == QEvent.MouseMove:
                if self.ctl.drag(cam_id, event.pos().x(), event.pos().y(),
                                 source.width(), source.height()):
                    self.update_frame()
                    return True
            elif event.type() == QEvent.MouseButtonRelease:
                if self.ctl.release():
                    return True
            return super().eventFilter(source, event)

else:

    class DeepflyGUI:  # pragma: no cover - placeholder for headless installs
        def __init__(self, *a, **k):
            raise ImportError("PyQt5 is required for the DeepFly GUI")


if __name__ == "__main__":
    main()
