"""Typed exceptions mirroring the reference's error taxonomy
(reference: src/error_handling.h, ~20 exception classes); a copy of
``dnascent_tpu/utils/errors.py``, every class with the same message."""


class DNAscentError(Exception):
    """Base class for all framework errors."""


class IOError_(DNAscentError):
    def __init__(self, path: str):
        super().__init__(f"Could not open file: {path}")


class MissingFast5(DNAscentError):
    def __init__(self, path: str):
        super().__init__(f"Could not find signal file: {path}")


class BadPod5Field(DNAscentError):
    pass


class VBZError(DNAscentError):
    def __init__(self, detail: str = ""):
        super().__init__("VBZ decompression failed"
                         + (f": {detail}" if detail else ""))


class OverwriteFailure(DNAscentError):
    def __init__(self):
        super().__init__("Output filename matches an input filename")


class InvalidOption(DNAscentError):
    def __init__(self, flag: str):
        super().__init__(f"Invalid option: {flag}")


class TrailingFlag(DNAscentError):
    def __init__(self, flag: str):
        super().__init__(f"Flag {flag} requires an argument")


class InvalidExtension(DNAscentError):
    def __init__(self, ext: str):
        super().__init__(f"Invalid output extension: {ext}")


class InvalidDevice(DNAscentError):
    def __init__(self, dev: str):
        super().__init__(f"Invalid device: {dev}")


class InvalidMappingThreshold(DNAscentError):
    def __init__(self):
        super().__init__("Mapping quality threshold must be >= 0")


class InvalidLengthThreshold(DNAscentError):
    def __init__(self):
        super().__init__("Read length threshold must be >= 100")


class DetectParsing(DNAscentError):
    def __init__(self):
        super().__init__("Malformed detect file record")


class ForkSenseData(DNAscentError):
    def __init__(self):
        super().__init__("Insufficient analogue calls for forkSense "
                         "incorporation estimate")


class BadBamField(DNAscentError):
    def __init__(self, field: str):
        super().__init__(f"Malformed BAM field: {field}")


class ParsingError(DNAscentError):
    pass


class NegativeLog(DNAscentError):
    def __init__(self):
        super().__init__("log of a negative value")


class MissingModelPath(DNAscentError):
    def __init__(self, path: str):
        super().__init__(f"Pore model files not found under: {path}")
