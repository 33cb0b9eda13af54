"""Browser GUI for the port's apps (counterpart of ``nunif_tpu/gui/``):

* :mod:`.progress`    — thread-safe progress event hub streamed to the
  browser over server-sent events
* :mod:`.persistence` — JSON settings store (``NUNIF_TPU_GUI_DIR``)
* :mod:`.locale`      — per-app ``locales/*.yml`` i18n loader
* :mod:`.server`      — the page and the jobs driving waifu2x / iw3 /
  stlizer (``python -m nunif_tpu_torch.gui``)
"""
from .progress import ProgressBridge, ProgressEvent
from .persistence import SettingsStore
from .locale import load_locale, LocaleCatalog

__all__ = [
    "ProgressBridge", "ProgressEvent", "SettingsStore",
    "load_locale", "LocaleCatalog",
]
