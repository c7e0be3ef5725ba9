"""Test gates of the port (the JAX package's ``testing/`` counterparts)."""

from .fake import backend_fault

__all__ = ["backend_fault"]
