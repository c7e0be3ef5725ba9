"""Test gates of the port (the JAX package's ``testing/`` counterparts)."""

from .fake import (FakeNvmeSource, FakeStripedNvmeSource, FaultPlan,
                   backend_fault, expected_bytes, make_test_file)

__all__ = ["FakeNvmeSource", "FakeStripedNvmeSource", "FaultPlan",
           "backend_fault", "expected_bytes", "make_test_file"]
