"""The serving leg of the port: so far the HBM tier of the residency
hierarchy (:mod:`.hbm_tier`).  The JAX package's weight streaming and KV
block pool are not part of the port yet."""

from .hbm_tier import HbmLease, HbmResidencyTier, hbm_tier

__all__ = ["HbmLease", "HbmResidencyTier", "hbm_tier"]
