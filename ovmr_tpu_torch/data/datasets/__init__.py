"""Importing this package registers every bundled dataset loader."""

from . import da, detection, dg, fine_grained, imagenet, ssl, synthetic  # noqa: F401
