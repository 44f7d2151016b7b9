"""Importing this package registers every bundled dataset loader."""

from . import fine_grained, synthetic  # noqa: F401
