"""Headless gradio stand-in: executes Blocks/Tab/Button layout code without
gradio (a copy of korean_f5_tts_tpu/utils/gradio_stub.py, framework-free).

Neither this repository's test image nor the card's machine has gradio, so
the port's two apps (`infer/infer_gradio.py:build_app`,
`train/finetune_gradio.py:build_app`) would otherwise never run their layout
code. This module provides the minimal component/event surface those apps
use, records the component tree, and lets tests and chip_smoke.py fire
registered callbacks headlessly.

Parity note: this mirrors the subset of the gradio 4.x API the reference's
UIs rely on (reference `infer_gradio.py:216,395,751`,
`finetune_gradio.py:326-450`); it renders nothing.
"""

from __future__ import annotations

import sys
import types

_CONTAINER_STACK: list = []


def _current_container():
    return _CONTAINER_STACK[-1] if _CONTAINER_STACK else None


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Event:
    def __init__(self, fn, inputs, outputs, trigger, source):
        self.fn = fn
        self.inputs = inputs
        self.outputs = outputs
        self.trigger = trigger  # "click" / "submit" / ...
        self.source = source

    def fire(self, *override):
        """Call the handler with each input component's current value (or
        explicit overrides) and assign results onto the output components."""
        vals = list(override) if override else [c.value for c in self.inputs]
        out = self.fn(*vals)
        outs = self.outputs
        if len(outs) == 1:
            out = (out,)
        for comp, v in zip(outs, out or ()):
            comp.value = v
        return out

    def then(self, fn=None, inputs=None, outputs=None, **kw):
        if fn is not None:
            return self.source._register("then", fn, inputs, outputs)
        return self


class Component:
    def __init__(self, *args, **kwargs):
        self.label = kwargs.get("label")
        self.value = kwargs.get("value")
        self.choices = kwargs.get("choices")
        if args:
            if isinstance(args[0], (list, tuple)):
                self.choices = args[0]
            elif self.label is None and isinstance(args[0], str) \
                    and type(self).__name__ not in ("Markdown", "HTML"):
                self.label = args[0]
        if type(self).__name__ in ("Markdown", "HTML") and args:
            self.value = args[0]
        if type(self).__name__ == "State":
            self.value = args[0] if args else kwargs.get("value")
        if type(self).__name__ == "Slider" and len(args) >= 3:
            self.minimum, self.maximum, self.value = args[0], args[1], args[2]
        self.kwargs = kwargs
        self.events: list[Event] = []
        parent = _current_container()
        if parent is not None:
            parent.children.append(self)

    def _register(self, trigger, fn, inputs=None, outputs=None, **kw):
        ev = Event(fn, _as_list(inputs), _as_list(outputs), trigger, self)
        self.events.append(ev)
        root = _ROOT_BLOCKS[-1] if _ROOT_BLOCKS else None
        if root is not None:
            root.all_events.append(ev)
        return ev

    # gradio event triggers used by the apps
    def click(self, fn, inputs=None, outputs=None, **kw):
        return self._register("click", fn, inputs, outputs, **kw)

    def submit(self, fn, inputs=None, outputs=None, **kw):
        return self._register("submit", fn, inputs, outputs, **kw)

    def change(self, fn, inputs=None, outputs=None, **kw):
        return self._register("change", fn, inputs, outputs, **kw)

    def upload(self, fn, inputs=None, outputs=None, **kw):
        return self._register("upload", fn, inputs, outputs, **kw)

    def stop_recording(self, fn, inputs=None, outputs=None, **kw):
        return self._register("stop_recording", fn, inputs, outputs, **kw)

    def select(self, fn, inputs=None, outputs=None, **kw):
        return self._register("select", fn, inputs, outputs, **kw)

    def clear(self, fn, inputs=None, outputs=None, **kw):
        return self._register("clear", fn, inputs, outputs, **kw)


class Container(Component):
    def __init__(self, *args, **kwargs):
        self.children: list = []
        super().__init__(*args, **kwargs)

    def __enter__(self):
        _CONTAINER_STACK.append(self)
        return self

    def __exit__(self, *exc):
        _CONTAINER_STACK.pop()
        return False

    def walk(self):
        for c in self.children:
            yield c
            if isinstance(c, Container):
                yield from c.walk()

    def find(self, cls_name: str = None, label: str = None):
        """First component matching class name and/or label."""
        for c in self.walk():
            if cls_name and type(c).__name__ != cls_name:
                continue
            if label and c.label != label:
                continue
            return c
        return None


_ROOT_BLOCKS: list = []


class Blocks(Container):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.title = kwargs.get("title")
        self.all_events: list[Event] = []

    def __enter__(self):
        _ROOT_BLOCKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _ROOT_BLOCKS.pop()
        return False

    def queue(self, *a, **k):
        return self

    def launch(self, *a, **k):  # headless: never serves
        return self


def update(**kwargs):
    return {"__type__": "update", **kwargs}


_WARNINGS: list[str] = []  # tests assert on these; real gradio toasts


def Warning(msg: str = "", *a, **k):  # noqa: N802 - gradio API name
    _WARNINGS.append(msg)


def Info(msg: str = "", *a, **k):  # noqa: N802
    _WARNINGS.append(msg)


_COMPONENTS = [
    "Markdown", "HTML", "Textbox", "Number", "Slider", "Checkbox", "Button",
    "Audio", "Microphone", "File", "Dropdown", "Radio", "Chatbot", "State",
    "Image", "JSON", "Dataframe", "Label",
]
_CONTAINERS = ["Row", "Column", "Tab", "TabItem", "Tabs", "Accordion", "Group"]


def make_module() -> types.ModuleType:
    mod = types.ModuleType("gradio")
    mod.__is_f5_tts_stub__ = True
    mod.Blocks = Blocks
    mod.update = update
    mod.Event = Event
    mod.Warning = Warning
    mod.Info = Info
    for name in _COMPONENTS:
        setattr(mod, name, type(name, (Component,), {}))
    for name in _CONTAINERS:
        setattr(mod, name, type(name, (Container,), {}))
    mod.themes = types.SimpleNamespace(Soft=lambda *a, **k: None,
                                       Default=lambda *a, **k: None)
    return mod


def install(force: bool = False) -> types.ModuleType:
    """Register the stub as `gradio` in sys.modules when the real package is
    absent (or force=True). Returns the active gradio module."""
    if not force:
        existing = sys.modules.get("gradio")
        if existing is not None and not getattr(existing, "__is_f5_tts_stub__", False):
            return existing
        try:
            import importlib.util

            if importlib.util.find_spec("gradio") is not None:
                import gradio

                return gradio
        except (ImportError, ValueError):
            pass
    mod = make_module()
    sys.modules["gradio"] = mod
    return mod


def uninstall() -> None:
    mod = sys.modules.get("gradio")
    if mod is not None and getattr(mod, "__is_f5_tts_stub__", False):
        del sys.modules["gradio"]
