"""Typed exceptions of the port's signal readers (the two of
``dnascent_tpu/utils/errors.py`` they raise; reference:
src/error_handling.h)."""


class DNAscentError(Exception):
    """Base class for all framework errors."""


class VBZError(DNAscentError):
    def __init__(self, detail: str = ""):
        super().__init__("VBZ decompression failed"
                         + (f": {detail}" if detail else ""))
