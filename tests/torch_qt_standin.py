"""A headless stand-in for the PyQt5 names the ``df3d`` correction GUIs use.

``deepfly3d_tpu/gui.py`` and ``deepfly3d_torch/gui.py`` import PyQt5 behind a
gate and keep every decision in their Qt-free ``GuiController``; what is
left in each is a shell that builds widgets, forwards events and blits
frames.  This module holds that shell to account without Qt: ``make()``
returns fresh module objects ``PyQt5``, ``PyQt5.QtWidgets``, ``PyQt5.QtCore``
and ``PyQt5.QtGui`` holding exactly the names both GUIs use.  The widgets
record what the shell asks of them (text, checked state, enabled state,
layout, the last pixmap's bytes, warnings) and draw nothing.  A GUI module
is then loaded as a fresh module object from its file under a private name
(``load_gui``), so the packages' own ``gui`` modules, imported without
PyQt5, stay as they are:

    qt = make()
    with installed(qt):                  # or monkeypatch.setitem(sys.modules, ...)
        gui = load_gui("deepfly3d_torch/gui.py", "_gui_under_standin")
    window = gui.DeepflyGUI()

Qt's own behaviour is kept where the shells depend on it: a click on a
checkable button toggles it before ``clicked`` is emitted, a combo box's
first item is current once added, ``setCurrentIndex`` emits nothing (a
user's pick is ``activate``), and an event goes through a widget's event
filters in order until one returns True (``send_event``).  Used by
tests/test_torch_gui.py and chip_smoke.py's GUI phase.
"""

from __future__ import annotations

import contextlib
import importlib.util
import sys
import types

MODULES = ("PyQt5", "PyQt5.QtWidgets", "PyQt5.QtCore", "PyQt5.QtGui")


class Signal:
    def __init__(self):
        self._slots = []

    def connect(self, slot):
        self._slots.append(slot)

    def emit(self, *args):
        for slot in self._slots:
            slot(*args)


class _Rect:
    def __init__(self, width):
        self._width = width

    def width(self):
        return self._width


class _FontMetrics:
    """A fixed 7 px per character."""

    def boundingRect(self, text):
        return _Rect(7 * len(text))


class _Point:
    def __init__(self, x, y):
        self._x, self._y = x, y

    def x(self):
        return self._x

    def y(self):
        return self._y


class _Size:
    def __init__(self, width):
        self._width = width

    def width(self):
        return self._width


class MouseEvent:
    """What ``eventFilter`` reads of a QMouseEvent: ``type()`` and ``pos()``."""

    def __init__(self, kind, x, y):
        self._kind, self._pos = kind, _Point(x, y)

    def type(self):
        return self._kind

    def pos(self):
        return self._pos


class KeyEvent:
    """What ``keyPressEvent`` reads of a QKeyEvent: ``key()``."""

    def __init__(self, key):
        self._key = key

    def key(self):
        return self._key


def send_event(widget, event) -> bool:
    """Qt's delivery: the widget's event filters in the order installed,
    until one returns True."""
    return any(f.eventFilter(widget, event) for f in widget.event_filters)


def make() -> types.SimpleNamespace:
    """Fresh stand-in modules -> namespace(modules={name: module}, warnings,
    dialogs, apps, shown).  Every call makes new classes, so no state is
    shared between two stand-ins."""
    warnings = []           # (parent, title, text) of each QMessageBox.warning
    dialogs = []            # keyword arguments of each QFileDialog call
    apps = []               # each QApplication
    shown = []              # each widget shown, in order

    class QWidget:
        def __init__(self, parent=None):
            self.children = []
            if parent is not None:
                parent.children.append(self)
            self.event_filters = []
            self.window_title = ""
            self.focus_requests = 0
            self.maximum_width = self.fixed_width = None
            self._layout = None
            self._size = (0, 0)
            self._enabled = True

        def resize(self, width, height):
            self._size = (int(width), int(height))

        def width(self):
            return self._size[0]

        def height(self):
            return self._size[1]

        def show(self):
            shown.append(self)

        def setLayout(self, layout):
            self._layout = layout

        def layout(self):
            return self._layout

        def setWindowTitle(self, title):
            self.window_title = title

        def setFocus(self):
            self.focus_requests += 1

        def setEnabled(self, enabled):
            self._enabled = bool(enabled)

        def isEnabled(self):
            return self._enabled

        def setMaximumWidth(self, width):
            self.maximum_width = width

        def setFixedWidth(self, width):
            self.fixed_width = width

        def installEventFilter(self, obj):
            self.event_filters.append(obj)

        def eventFilter(self, source, event):
            return False

    class QPushButton(QWidget):
        def __init__(self, text, parent=None):
            super().__init__(parent)
            self._text = text
            self._checkable = self._checked = False
            self.clicked = Signal()

        def text(self):
            return self._text

        def fontMetrics(self):
            return _FontMetrics()

        def setCheckable(self, checkable):
            self._checkable = bool(checkable)

        def isCheckable(self):
            return self._checkable

        def setChecked(self, checked):
            self._checked = bool(checked) and self._checkable

        def isChecked(self):
            return self._checked

        def click(self):
            if self._checkable:
                self._checked = not self._checked
            self.clicked.emit()

    class QLineEdit(QWidget):
        def __init__(self, text="", parent=None):
            super().__init__(parent)
            self._text = text

        def text(self):
            return self._text

        def setText(self, text):
            self._text = text

    class QComboBox(QWidget):
        def __init__(self, parent=None):
            super().__init__(parent)
            self._items = []
            self._index = -1
            self.activated = Signal()

        def addItem(self, text, data=None):
            self._items.append((text, data))
            if self._index < 0:
                self._index = 0

        def count(self):
            return len(self._items)

        def itemText(self, index):
            return self._items[index][0]

        def currentIndex(self):
            return self._index

        def currentData(self):
            return self._items[self._index][1] if self._index >= 0 else None

        def setCurrentIndex(self, index):
            self._index = index

        def activate(self, index):
            """A user's pick: the index becomes current, then ``activated``."""
            self.setCurrentIndex(index)
            self.activated.emit(index)

    class QLabel(QWidget):
        def __init__(self, parent=None):
            super().__init__(parent)
            self.scaled_contents = False
            self._pixmap = None

        def setScaledContents(self, on):
            self.scaled_contents = bool(on)

        def setPixmap(self, pixmap):
            self._pixmap = pixmap

        def pixmap(self):
            return self._pixmap

    class _BoxLayout:
        def __init__(self):
            self.items = []          # ("widget", w) / ("layout", l) / ("stretch", None)
            self.alignment = None

        def addWidget(self, widget):
            self.items.append(("widget", widget))

        def addLayout(self, layout):
            self.items.append(("layout", layout))

        def addStretch(self):
            self.items.append(("stretch", None))

        def setAlignment(self, alignment):
            self.alignment = alignment

    class QHBoxLayout(_BoxLayout):
        pass

    class QVBoxLayout(_BoxLayout):
        pass

    class _Desktop:
        def size(self):
            return _Size(1920)

    class QApplication:
        def __init__(self, argv):
            self.argv = list(argv)
            self.executed = False
            apps.append(self)

        def desktop(self):
            return _Desktop()

        def exec_(self):
            self.executed = True
            return 0

    class QMessageBox:
        Ok = 0x400

        @staticmethod
        def warning(parent, title, text):
            warnings.append((parent, title, text))
            return QMessageBox.Ok

    class QFileDialog:
        DontUseNativeDialog = 0x1
        answer = ""              # the folder a user would pick

        @staticmethod
        def getExistingDirectory(parent=None, caption="", directory="", options=0):
            dialogs.append({"caption": caption, "directory": directory, "options": options})
            return QFileDialog.answer

    class QEvent:
        MouseButtonPress = 2
        MouseButtonRelease = 3
        MouseMove = 5

    class Qt:
        AlignRight = 0x2
        Key_A, Key_C, Key_D, Key_I, Key_T, Key_X = 0x41, 0x43, 0x44, 0x49, 0x54, 0x58

    class QImage:
        Format_RGB888 = 13

        def __init__(self, data, width, height, bytes_per_line, fmt):
            self.bytes = bytes(data)            # Qt would borrow the buffer; keep a copy
            self._width, self._height = width, height
            self._stride, self._format = bytes_per_line, fmt

        def width(self):
            return self._width

        def height(self):
            return self._height

        def bytesPerLine(self):
            return self._stride

        def format(self):
            return self._format

    class QPixmap:
        def __init__(self, image):
            self.image = image

        @staticmethod
        def fromImage(image):
            return QPixmap(image)

    def module(name, **names):
        mod = types.ModuleType(name)
        mod.__dict__.update(names)
        return mod

    widgets = module("PyQt5.QtWidgets", QWidget=QWidget, QPushButton=QPushButton,
                     QLineEdit=QLineEdit, QComboBox=QComboBox, QLabel=QLabel,
                     QHBoxLayout=QHBoxLayout, QVBoxLayout=QVBoxLayout,
                     QApplication=QApplication, QMessageBox=QMessageBox,
                     QFileDialog=QFileDialog)
    core = module("PyQt5.QtCore", QEvent=QEvent, Qt=Qt)
    gui = module("PyQt5.QtGui", QImage=QImage, QPixmap=QPixmap)
    package = module("PyQt5", QtWidgets=widgets, QtCore=core, QtGui=gui)
    package.__path__ = []
    modules = dict(zip(MODULES, (package, widgets, core, gui)))
    return types.SimpleNamespace(modules=modules, warnings=warnings, dialogs=dialogs,
                                 apps=apps, shown=shown)


@contextlib.contextmanager
def installed(qt):
    """``qt``'s modules in ``sys.modules`` for the block; what was there
    (nothing, where PyQt5 is not installed) is put back after."""
    saved = {name: sys.modules.get(name) for name in MODULES}
    sys.modules.update(qt.modules)
    try:
        yield qt
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def load_gui(path, name):
    """The GUI module at ``path`` as a fresh module object named ``name``,
    not entered in ``sys.modules``; it imports PyQt5 from whatever
    ``sys.modules`` holds at the call."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def describe(obj):
    """A widget's or layout's tree as nested lists: a widget as its type
    name and text, a layout as its type name, alignment and items."""
    if hasattr(obj, "items"):
        return [type(obj).__name__, obj.alignment,
                [describe(item) if kind != "stretch" else "stretch" for kind, item in obj.items]]
    text = obj.text() if hasattr(obj, "text") else None
    return [type(obj).__name__, text]


def view_state(window):
    """What a user sees of a ``DeepflyGUI``: the textbox, which mode
    button is checked, whether the joint combo is enabled and its current
    index, how often the window asked for the focus, and each view's last
    image as (width, height, stride, format, bytes)."""
    return {
        "textbox": window.textbox_img_id.text(),
        "focus_requests": window.focus_requests,
        "checked": [b.text() for b in (window.button_image_mode, window.button_pose_mode,
                                       window.button_correction_mode) if b.isChecked()],
        "combo_enabled": window.combo_joint_id.isEnabled(),
        "combo_index": window.combo_joint_id.currentIndex(),
        "views": [None if iv.pixmap() is None else
                  (iv.pixmap().image.width(), iv.pixmap().image.height(),
                   iv.pixmap().image.bytesPerLine(), iv.pixmap().image.format(),
                   iv.pixmap().image.bytes)
                  for iv in window.image_views],
    }


def button(window, text):
    """The window's push button labelled ``text`` (``Go`` is no attribute)."""
    found = [w for w in window.children if type(w).__name__ == "QPushButton"
             and w.text() == text]
    if len(found) != 1:
        raise LookupError(f"{len(found)} buttons labelled {text!r}")
    return found[0]
