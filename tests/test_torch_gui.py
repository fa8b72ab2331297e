"""The ``df3d`` correction GUI in the port (``deepfly3d_torch/gui.py``) vs the JAX GUI.

PyQt5 is installed nowhere these tests run, and both GUIs gate their Qt
import.  So:

* without PyQt5 (the packages' own ``gui`` modules): ``parse_cli_args``
  against JAX's on the same argvs (the port also reads ``--device X``,
  default ``"cuda"``), both ``main()``s exit with their messages, both
  placeholder ``DeepflyGUI``s raise ImportError;
* under the headless Qt stand-in (``tests/torch_qt_standin.py``), each GUI
  loaded as a fresh module from its file: the same widgets and layout, the
  same ``main()`` flow, and one scripted session through both shells on
  copies of the same seeded recording (golden 2D and calibration), compared
  after every step: the textbox, the checked mode button, the joint combo,
  the warnings and each view's last image, byte for byte; after Save, the
  two result pickles and correction databases within 1e-6;
* Auto-correct on 2 frames in both shells (the network on the CPU in both):
  the corrected points2d within 1e-3 px; without calibration both warn
  alike; the port's default device raises without a card, as ``Core`` does;
* ``python -m deepfly3d_torch.gui`` without PyQt5 exits 1 with its message.
"""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_qt_standin as standin
from deepfly3d_tpu import gui as jax_gui
from deepfly3d_torch import gui
from deepfly3d_torch.io import result_schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "tests", "data", "reference")
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "reference_df3d")
GUI_FILES = {"jax": os.path.join(REPO, "deepfly3d_tpu", "gui.py"),
             "port": os.path.join(REPO, "deepfly3d_torch", "gui.py")}
VIEW_WH = (480, 240)            # each camera view's widget size: half the 960x480 frame
SAVED_ATOL = 1e-6
PIC_ATOL_PX = 1e-3


@pytest.fixture(autouse=True)
def _few_threads():
    """2 intra-op threads (the suite runs 6 workers on the cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def qt(monkeypatch):
    """The stand-in in ``sys.modules`` for this test only, and both GUIs
    loaded under it as fresh modules (``qt.jax``, ``qt.port``)."""
    qt = standin.make()
    for name, mod in qt.modules.items():
        monkeypatch.setitem(sys.modules, name, mod)
    qt.jax = standin.load_gui(GUI_FILES["jax"], "_jax_gui_under_standin")
    qt.port = standin.load_gui(GUI_FILES["port"], "_port_gui_under_standin")
    qt.Qt = qt.modules["PyQt5.QtCore"].Qt
    qt.QEvent = qt.modules["PyQt5.QtCore"].QEvent
    return qt


def _recording(root, frames):
    """The bundled recording's first ``frames`` frames under
    ``root/sample/test``, a path whose camera ordering (0-6) ``Core`` knows."""
    rec = os.path.join(root, "sample", "test")
    os.makedirs(rec)
    for c in range(7):
        for t in range(frames):
            name = f"camera_{c}_img_{t}.jpg"
            shutil.copy(os.path.join(REFERENCE, name), rec)
    return rec


def _golden():
    with open(os.path.join(GOLDEN_DIR, "df3d_result_2d.pkl"), "rb") as f:
        golden_2d = pickle.load(f)
    with open(os.path.join(GOLDEN_DIR, "df3d_result_3d.pkl"), "rb") as f:
        golden_3d = pickle.load(f)
    return golden_2d, golden_3d


def _seed(core, frames):
    """Golden 2D and calibration, as tests/test_torch_options.py's ``_seeded``."""
    golden_2d, golden_3d = _golden()
    core.points2d = np.array(golden_2d["points2d"][:, :frames])
    core.conf = np.array(golden_2d["heatmap_confidence"][:, :frames])
    core.calib = result_schema.extract_calib(golden_3d)


def _windows(qt, tmp_path, frames):
    """(port window, JAX window), each set up on its own copy of the
    recording, seeded alike, views laid out at ``VIEW_WH``."""
    windows = []
    for name in ("port", "jax"):
        rec = _recording(str(tmp_path / name), frames)
        window = getattr(qt, name).DeepflyGUI()
        window.setup(rec, frames, **({"device": "cpu"} if name == "port" else {}))
        _seed(window.core, frames)
        for iv in window.image_views:
            iv.resize(*VIEW_WH)
        windows.append(window)
    return windows


def _state(qt, window):
    state = standin.view_state(window)
    state["warnings"] = [(title, text) for parent, title, text in qt.warnings
                         if parent is window]
    return state


def _assert_same(qt, port, ref, step):
    got, want = _state(qt, port), _state(qt, ref)
    assert got["views"] == want["views"], f"{step}: the views differ"
    del got["views"], want["views"]
    assert got == want, step


def _assert_close(got, want, where=""):
    """Nested dicts / arrays within ``SAVED_ATOL``."""
    if isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}/{k}")
    elif want is None or isinstance(want, (str, bool)):
        assert got == want, where
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   atol=SAVED_ATOL, rtol=0, err_msg=where)


# ------------------------------------------------------- without PyQt5


@pytest.mark.parametrize("argv", [
    ["df3d"],
    ["df3d", "/data/rec"],
    ["df3d", "/data/rec", "12"],
    ["df3d", "/data/rec", "twelve"],
    ["df3d", "/data/rec", "12", "extra", "args"],
    ["df3d", "--device", "cpu", "/data/rec", "12"],
    ["df3d", "/data/rec", "12", "--device", "cpu"],
    ["df3d", "/data/rec", "--device", "cuda:1"],
])
def test_parse_cli_args_matches_jax(argv):
    got = gui.parse_cli_args(argv)
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    assert got.pop("device") == device
    positional = [a for i, a in enumerate(argv)
                  if a != "--device" and (i == 0 or argv[i - 1] != "--device")]
    assert got == jax_gui.parse_cli_args(positional)
    if "--device" not in argv:
        assert got == jax_gui.parse_cli_args(argv)


def test_main_and_placeholders_without_pyqt():
    if gui.HAS_PYQT or jax_gui.HAS_PYQT:
        pytest.skip("PyQt5 is installed: the headless paths are not taken")
    with pytest.raises(SystemExit, match="df3d-cli"):
        jax_gui.main()
    with pytest.raises(SystemExit) as exc:
        gui.main()
    message = str(exc.value)
    assert "requires PyQt5" in message and "python -m deepfly3d_torch.cli" in message
    assert "df3d-cli" not in message
    for placeholder in (jax_gui.DeepflyGUI, gui.DeepflyGUI):
        with pytest.raises(ImportError, match="PyQt5"):
            placeholder()
    with pytest.raises(SystemExit, match="--device needs a value"):
        gui.parse_cli_args(["gui.py", "/data/rec", "--device"])


# ------------------------------------------------ under the Qt stand-in


def test_standin_stays_out_of_the_packages(qt):
    """The stand-in's GUIs are fresh modules; the packages' own ``gui``
    modules keep their no-PyQt5 state."""
    assert qt.port.HAS_PYQT and qt.jax.HAS_PYQT
    assert qt.port is not gui and sys.modules["deepfly3d_torch.gui"] is gui
    assert not gui.HAS_PYQT and not jax_gui.HAS_PYQT
    methods = {n for n, v in vars(qt.jax.DeepflyGUI).items() if callable(v)}
    assert methods <= {n for n, v in vars(qt.port.DeepflyGUI).items() if callable(v)}


def test_widgets_and_layout_match_jax(qt, tmp_path):
    port, ref = _windows(qt, tmp_path, 2)
    assert standin.describe(port.layout()) == standin.describe(ref.layout())
    assert [(type(w).__name__, getattr(w, "text", lambda: None)(), w.maximum_width,
             w.fixed_width, getattr(w, "isCheckable", lambda: None)()) for w in port.children] \
        == [(type(w).__name__, getattr(w, "text", lambda: None)(), w.maximum_width,
             w.fixed_width, getattr(w, "isCheckable", lambda: None)()) for w in ref.children]
    combo, ref_combo = port.combo_joint_id, ref.combo_joint_id
    assert [combo.itemText(i) for i in range(combo.count())] \
        == [ref_combo.itemText(i) for i in range(ref_combo.count())]
    assert combo.count() == 39
    assert [iv.cam_id for iv in port.image_views] == [0, 1, 2, 4, 5, 6]
    assert all(iv.scaled_contents and iv.event_filters == [port] for iv in port.image_views)
    assert port.window_title == port.core.input_folder
    assert ref.window_title == ref.core.input_folder
    assert str(port.core.device) == "cpu"
    for window in (port, ref):
        window.set_width(1200)
    assert (port.width(), port.height()) == (ref.width(), ref.height()) == (1200, 500)
    _assert_same(qt, port, ref, "after setup")


def test_prompt_for_directory_matches_jax(qt, tmp_path):
    """No folder given: the folder dialog, asked the same way by both."""
    rec = _recording(str(tmp_path), 2)
    qt.modules["PyQt5.QtWidgets"].QFileDialog.answer = rec
    port, ref = qt.port.DeepflyGUI(), qt.jax.DeepflyGUI()
    port.setup(None, 2, device="cpu")
    ref.setup(None, 2)
    assert len(qt.dialogs) == 2 and qt.dialogs[0] == qt.dialogs[1]
    assert qt.dialogs[0]["caption"] == "Select Directory"
    assert port.core.input_folder == ref.core.input_folder == rec


def test_main_under_standin_matches_jax(qt, tmp_path, monkeypatch):
    """The flow of both ``main()``s: the usage and result-file checks, then
    the window at the desktop's width, shown, and the event loop."""
    rec = _recording(str(tmp_path), 2)
    for argv, match in (([], "Usage: "), ([rec, "2"], "first and generate a df3d_result")):
        monkeypatch.setattr(sys, "argv", ["df3d"] + argv)
        with pytest.raises(AssertionError, match=match):
            qt.jax.main()
        monkeypatch.setattr(sys, "argv", ["gui.py"] + argv + ["--device", "cpu"])
        with pytest.raises(SystemExit, match=match) as exc:
            qt.port.main()
        if argv:
            assert "python -m deepfly3d_torch.cli" in str(exc.value)
        else:
            assert "python -m deepfly3d_torch.gui" in str(exc.value)
    assert not qt.apps
    os.makedirs(rec + "_df3d")
    shutil.copy(os.path.join(GOLDEN_DIR, "df3d_result_2d.pkl"), rec + "_df3d")
    for name, argv in (("jax", ["df3d", rec, "2"]),
                       ("port", ["gui.py", "--device", "cpu", rec, "2"])):
        monkeypatch.setattr(sys, "argv", argv)
        getattr(qt, name).main()
    assert [app.executed for app in qt.apps] == [True, True]
    assert [app.argv for app in qt.apps] == [[], []]
    ref, port = qt.shown
    assert str(port.core.device) == "cpu" and port.core.num_images == ref.core.num_images == 2
    assert (port.width(), port.height()) == (ref.width(), ref.height()) == (1920, 800)
    _assert_same(qt, port, ref, "main")


def test_shell_session_matches_jax(qt, tmp_path):
    """One scripted session through both shells, compared after every step."""
    port, ref = _windows(qt, tmp_path, 4)
    Qt, QEvent = qt.Qt, qt.QEvent

    def click(text):
        return lambda w: standin.button(w, text).click()

    def go(text):
        def step(w):
            w.textbox_img_id.setText(text)
            standin.button(w, "Go").click()
        return step

    def key(code):
        return lambda w: w.keyPressEvent(standin.KeyEvent(code))

    def mouse(kind, dx=0.0, dy=0.0):
        """A mouse event on camera 1's view, at joint 2 of the current frame
        plus (dx, dy) view pixels; returns whether the filter took it."""
        def step(w):
            x, y = w.core.corrected_points2d(1, w.ctl.img_id)[2] if kind != "release" \
                else (0.0, 0.0)
            sx, sy = VIEW_WH[0] / 960.0, VIEW_WH[1] / 480.0
            kinds = {"press": QEvent.MouseButtonPress, "move": QEvent.MouseMove,
                     "release": QEvent.MouseButtonRelease}
            return standin.send_event(w.image_views[1], standin.MouseEvent(
                kinds[kind], x * sx + dx, y * sy + dy))
        return step

    def pick_joint(index):
        return lambda w: w.combo_joint_id.activate(index)

    steps = [
        ("initial state", lambda w: None),
        ("Image again", click("Image")),
        ("Pose", click("Pose")),
        ("pick joint 2", pick_joint(3)),
        (">", click(">")), (">", click(">")), ("<", click("<")),
        (">>", click(">>")), (">", click(">")), ("<<", click("<<")), ("<", click("<")),
        ("Go 3", go("3")), ("Go not-a-number", go("not-a-number")), ("Go 99", go("99")),
        ("next error", click("next error >")), ("previous error", click("< previous error")),
        ("all joints", pick_joint(0)),
        ("key A", key(Qt.Key_A)), ("key D", key(Qt.Key_D)), ("key X", key(Qt.Key_X)),
        ("key C", key(Qt.Key_C)), ("key I", key(Qt.Key_I)), ("key T", key(Qt.Key_T)),
        ("press in image mode", mouse("press")),
        ("Correction", click("Correction")),
        ("press", mouse("press")), ("move", mouse("move", 60.0, 30.0)),
        ("release", mouse("release")), ("release again", mouse("release")),
        ("move after release", mouse("move", -40.0, 10.0)),
        ("Save", click("Save")),
    ]
    for name, step in steps:
        assert step(port) == step(ref), name
        _assert_same(qt, port, ref, name)
    # the session really moved through its states
    assert port.ctl.mode == "correction" and port.ctl.joint_being_dragged is None
    texts = {text for _, _, text in qt.warnings}
    assert any("image id" in t for t in texts) and any("next images" in t for t in texts)
    assert port.focus_requests == 1
    img = port.ctl.img_id
    assert port.core.db.read(1, img) is not None
    saved = []
    for window in (port, ref):
        with open(window.core.save_path, "rb") as f:
            saved.append(pickle.load(f))
        with open(window.core.db.db_path, "rb") as f:
            db = pickle.load(f)
        saved.append({k: v for k, v in db.items() if k not in ("folder", "meta")})
    assert saved[0]["points2d"].shape == (7, 4, 38, 2) and saved[0]["points3d"] is not None
    _assert_close(saved[0], saved[2], "result")
    _assert_close(saved[1], saved[3], "corrections")
    assert 1 in saved[1] and img in saved[1][1]


def test_auto_correct_matches_jax(qt, tmp_path):
    """Auto-correct on 2 frames in both shells, then again without a calibration."""
    port, ref = _windows(qt, tmp_path, 2)
    before = np.array(port.core.points2d)
    for window in (port, ref):
        standin.button(window, "Pose").click()
        standin.button(window, "Auto-correct").click()
    got, want = port.core.points2d, ref.core.points2d
    assert got.shape == (7, 2, 38, 2) and np.isfinite(got).all()
    assert not np.allclose(got, before)
    w, h = port.core.image_shape
    px = np.abs(got - want) * np.array([h, w])
    assert px.max() <= PIC_ATOL_PX, f"corrected points2d differ by {px.max()} px"
    assert _state(qt, port)["warnings"] == _state(qt, ref)["warnings"] == []
    for window in (port, ref):
        window.core.calib = None
        standin.button(window, "Auto-correct").click()
    got, want = _state(qt, port)["warnings"], _state(qt, ref)["warnings"]
    assert got == want and len(got) == 1 and "calibration" in got[0][1]


def test_auto_correct_on_the_default_device_needs_a_card(qt, tmp_path, monkeypatch):
    """The port's default device is the card: without one, Auto-correct
    raises as ``Core`` does, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = _recording(str(tmp_path), 2)
    window = qt.port.DeepflyGUI()
    window.setup(rec, 2)
    _seed(window.core, 2)
    assert window.core.device == "cuda"
    standin.button(window, "Pose").click()
    before = np.array(window.core.points2d)
    with pytest.raises(RuntimeError, match="is_available"):
        standin.button(window, "Auto-correct").click()
    np.testing.assert_array_equal(window.core.points2d, before)
    assert not qt.warnings


# ------------------------------------------------------------- entry point


def test_module_entry_point_without_pyqt():
    """``python -m deepfly3d_torch.gui FOLDER`` where PyQt5 is missing: exit
    status 1 and the message that points to the port's CLI."""
    if gui.HAS_PYQT:
        pytest.skip("PyQt5 is installed: the window would open")
    done = subprocess.run([sys.executable, "-m", "deepfly3d_torch.gui", REFERENCE],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert done.returncode == 1
    assert "requires PyQt5" in done.stderr and "python -m deepfly3d_torch.cli" in done.stderr
