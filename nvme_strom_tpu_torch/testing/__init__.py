"""Test gates of the port (the JAX package's ``testing/`` counterparts)."""

from .fake import (FakeNvmeSource, FakeStripedNvmeSource, FaultPlan,
                   backend_fault, expected_bytes, flip_resident_hbm,
                   flip_resident_host, make_test_file, reset_residency)

__all__ = ["FakeNvmeSource", "FakeStripedNvmeSource", "FaultPlan",
           "backend_fault", "expected_bytes", "flip_resident_hbm",
           "flip_resident_host", "make_test_file", "reset_residency"]
