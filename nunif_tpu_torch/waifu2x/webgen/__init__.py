"""Static i18n front pages of the waifu2x web server (counterpart of
``nunif_tpu/waifu2x/webgen``): ``index.html`` (en) and ``index.{lang}.html``,
rendered once from ``templates/index.html.tpl`` and ``locales/*.yml``."""
from .gen import (generate_pages, load_locales, parse_locale, pick_language,
                  render_page, render_pages)

__all__ = ["generate_pages", "load_locales", "parse_locale", "pick_language",
           "render_page", "render_pages"]
