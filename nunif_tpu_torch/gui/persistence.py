"""Persistent GUI settings (counterpart of ``nunif_tpu/gui/persistence.py``;
the same files, so both GUIs share them).

Role parity target: reference nunif/gui/ persistent widget/layout state
(wx.lib persistence + per-app config files; e.g. waifu2x/gui.py restores
every control's last value).  Here: a JSON key-value store per app under
``~/.nunif_tpu/gui/<app>.json`` with atomic writes and schema defaults.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Optional


def default_config_dir() -> str:
    return os.environ.get(
        "NUNIF_TPU_GUI_DIR",
        os.path.join(os.path.expanduser("~"), ".nunif_tpu", "gui"))


class SettingsStore:
    def __init__(self, app_name: str, config_dir: Optional[str] = None,
                 defaults: Optional[dict] = None):
        self.app_name = app_name
        self.config_dir = config_dir or default_config_dir()
        self.path = os.path.join(self.config_dir, f"{app_name}.json")
        self.defaults = dict(defaults or {})
        self._lock = threading.Lock()
        self._data = self._load()

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                return {}
            return data
        except (OSError, ValueError):
            return {}

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            if key in self._data:
                return self._data[key]
            if key in self.defaults:
                return self.defaults[key]
            return default

    def as_dict(self) -> dict:
        with self._lock:
            merged = dict(self.defaults)
            merged.update(self._data)
            return merged

    def set(self, key: str, value: Any):
        self.update({key: value})

    def update(self, values: dict):
        with self._lock:
            self._data.update(values)
            self._save()

    def reset(self):
        with self._lock:
            self._data = {}
            self._save()

    def _save(self):
        os.makedirs(self.config_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.config_dir, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self._data, f, indent=2, sort_keys=True)
        os.replace(tmp, self.path)
