"""Test gates of the port (the JAX package's ``testing/`` counterparts)."""
