"""Render the waifu2x web front page per locale (counterpart of
``nunif_tpu/waifu2x/webgen/gen.py``).

``generate_pages(out_dir)`` writes ``index.html`` (en) and
``index.{lang}.html`` for every other ``locales/*.yml``; a key missing from
a locale falls back to English.  The template is ``string.Template``
(``${key}``).  The locale files are flat ``key: "string"`` tables, read by
``parse_locale`` below: the port needs no YAML package.
"""
from __future__ import annotations

import json
import os
import string

SELF_DIR = os.path.dirname(os.path.abspath(__file__))
LOCALE_DIR = os.path.join(SELF_DIR, "locales")
TEMPLATE_FILE = os.path.join(SELF_DIR, "templates", "index.html.tpl")
DEFAULT_LANG = "en"

GENERATED_NOTE = ("This file was generated by nunif_tpu_torch.waifu2x.webgen. "
                  "Do not edit manually.")


def _scalar(v: str) -> str:
    """A flat YAML scalar: double-quoted (JSON escapes), single-quoted
    ('' for a quote) or plain."""
    if len(v) >= 2 and v[0] == v[-1] == '"':
        return json.loads(v)
    if len(v) >= 2 and v[0] == v[-1] == "'":
        return v[1:-1].replace("''", "'")
    return v


def parse_locale(text: str) -> dict:
    """{key: string} of a flat ``key: value`` locale file; blank lines and
    ``#`` comments are skipped, anything nested raises ``ValueError``."""
    out = {}
    for n, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        key, sep, value = line.partition(":")
        if not sep or line[0].isspace():
            raise ValueError(f"line {n}: not a flat 'key: value' entry: {line!r}")
        out[key.strip()] = _scalar(value.strip())
    return out


def load_locales(locale_dir: str = LOCALE_DIR) -> dict:
    """{lang: {key: string}} for every ``.yml`` table in ``locale_dir``."""
    locales = {}
    for ent in sorted(os.listdir(locale_dir)):
        if ent.endswith(".yml"):
            with open(os.path.join(locale_dir, ent), encoding="utf-8") as f:
                locales[ent[:-len(".yml")]] = parse_locale(f.read())
    return locales


def render_page(lang: str, table: dict, template_file: str = TEMPLATE_FILE):
    with open(template_file, encoding="utf-8") as f:
        tpl = string.Template(f.read())
    return tpl.substitute(dict(table, lang=lang, generated_note=GENERATED_NOTE))


def render_pages(locale_dir: str = LOCALE_DIR,
                 template_file: str = TEMPLATE_FILE) -> dict:
    """{lang: page} for every locale, missing keys taken from English."""
    locales = load_locales(locale_dir)
    base = locales.get(DEFAULT_LANG, {})
    return {lang: render_page(lang, {**base, **table}, template_file)
            for lang, table in locales.items()}


def generate_pages(out_dir: str, locale_dir: str = LOCALE_DIR,
                   template_file: str = TEMPLATE_FILE) -> list:
    """Write one static page per locale; returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for lang, page in render_pages(locale_dir, template_file).items():
        name = "index.html" if lang == DEFAULT_LANG else f"index.{lang}.html"
        path = os.path.join(out_dir, name)
        with open(path, "w", encoding="utf-8") as f:
            f.write(page)
        written.append(path)
    return written


def pick_language(accept_language: str, available: list) -> str:
    """Best locale for an Accept-Language header (q-weighted, with the
    primary subtag as a fallback: 'ja-JP' matches 'ja')."""
    ranked = []
    for i, part in enumerate((accept_language or "").split(",")):
        part = part.strip()
        if not part:
            continue
        lang, _, qspec = part.partition(";")
        q = 1.0
        if qspec.strip().startswith("q="):
            try:
                q = float(qspec.strip()[2:])
            except ValueError:
                q = 0.0
        ranked.append((-q, i, lang.strip().lower()))
    for _, _, lang in sorted(ranked):
        primary = lang.split("-")[0]
        for cand in (lang, primary):
            for avail in available:
                if avail.lower().replace("_", "-") == cand \
                        or avail.lower().split("_")[0] == cand:
                    return avail
    return DEFAULT_LANG
