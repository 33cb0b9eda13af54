"""Locale / i18n loader (counterpart of ``nunif_tpu/gui/locale.py``).

Loads ``locales/*.yml`` translation tables (en / ja / zh_CN) keyed by the
English source string, falling back to the key itself when a translation
is missing.  The tables are flat ``key: value`` lines (the reference's
format), read by a small parser of that form, so the port needs no YAML
package.
"""
from __future__ import annotations

import os
from typing import Optional

_BUILTIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "locales")


def parse_table(text: str) -> dict:
    """``key: value`` lines -> dict; ``#`` comments and blank lines
    skipped, one pair of surrounding quotes taken off, ``true`` / ``false``
    read as booleans."""
    table = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or ":" not in line:
            continue
        key, _, value = line.partition(":")
        key, value = key.strip(), value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "'\"":
            value = value[1:-1]
        elif value in ("true", "false"):
            value = value == "true"
        table[key] = value
    return table


class LocaleCatalog:
    """Translation table: ``catalog("Start")`` -> localized string."""

    def __init__(self, lang: str, table: Optional[dict] = None):
        self.lang = lang
        self.table = dict(table or {})
        self.rtl = bool(self.table.pop("_RTL", False))  # he_IL etc.

    def __call__(self, key: str) -> str:
        v = self.table.get(key)
        return v if isinstance(v, str) and v else key

    gettext = __call__

    def merge(self, other: "LocaleCatalog") -> "LocaleCatalog":
        merged = dict(self.table)
        merged.update(other.table)
        cat = LocaleCatalog(other.lang or self.lang, merged)
        cat.rtl = other.rtl or self.rtl
        return cat


def _candidates(lang: str):
    """'ja_JP.UTF-8' -> ['ja_JP', 'ja']; always ends with 'en'."""
    lang = (lang or "en").split(".")[0].replace("-", "_")
    out = [lang]
    if "_" in lang:
        out.append(lang.split("_")[0])
    if "en" not in out:
        out.append("en")
    return out


def load_locale(lang: Optional[str] = None,
                locale_dir: Optional[str] = None) -> LocaleCatalog:
    """The best-matching catalog for ``lang`` (default: $LANG); an app's
    ``locale_dir`` tables overlay the built-in GUI strings."""
    lang = lang or os.environ.get("LANG", "en")
    cat = _load_dir(_BUILTIN_DIR, lang)
    if locale_dir:
        cat = cat.merge(_load_dir(locale_dir, lang))
    return cat


def _load_dir(d: str, lang: str) -> LocaleCatalog:
    for cand in _candidates(lang):
        path = os.path.join(d, f"{cand}.yml")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                return LocaleCatalog(cand, parse_table(f.read()))
    return LocaleCatalog("en", {})


def available_languages(locale_dir: Optional[str] = None) -> list:
    d = locale_dir or _BUILTIN_DIR
    try:
        return sorted(os.path.splitext(f)[0] for f in os.listdir(d)
                      if f.endswith(".yml"))
    except OSError:
        return []
