from . import models  # noqa: F401  (registers waifu2x model names)
