"""Exceptions and log prefix.

JAX-side equivalents of the reference's exception types
(reference: include/SVGDCpp/Exceptions.hpp:16-56).
"""

SVGD_LOG_PREFIX = "[SVGD-JAX] "


class SVGDError(Exception):
    """Base class for all svgdcpp_jax errors."""

    prefix = "[Error] "

    def __init__(self, message: str = ""):
        super().__init__(SVGD_LOG_PREFIX + self.prefix + message)


class DimensionMismatchError(SVGDError):
    """Raised when array/vector dimensions are incompatible.

    Mirrors DimensionMismatchException (Exceptions.hpp:23-36).
    """

    prefix = "[Dimension Mismatch Error] "


class UnsetError(SVGDError):
    """Raised when a required function/member has not been set.

    Mirrors UnsetException (Exceptions.hpp:43-56).
    """

    prefix = "[Unset Error] "


def compare_vector_sizes(a, b) -> bool:
    """Return True if two 1-D arrays have the same length.

    Mirrors CompareVectorSizes (Core.hpp:48-52).
    """
    return int(a.shape[0]) == int(b.shape[0])
