"""Pushdown planning: where a packed (``.cpk``) scan expands its rows.

Ported from the JAX package's ``scan/planner.py`` (``transport_rates``,
``PushdownDecision``, ``decide_pushdown``).  The rule: when the
host→device link is slower than the SSD, packed bytes must cross the link
packed and expand on the device (``chip``); when the SSD is the slower
leg, packed bytes leave the disk and expand on the host (``host``), which
keeps the decode off the device; a codec that saves too little is not
worth either (``raw``, the heap scan).

The rates come from, in order: config ``pushdown_h2d_gbps`` /
``pushdown_ssd_gbps``; the live host→device meter of the scan pipeline
(:data:`..hbm.staging.h2d_meter`, h2d only); the defaults below.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..config import config

__all__ = ["H2D_GBPS_DEFAULT", "SSD_GBPS_DEFAULT", "transport_rates",
           "PushdownDecision", "decide_pushdown"]

# measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit: pinned host->device copies ("pinned h2d") and the scanner's
# read-only pass over a cold 1 GiB heap table ("read-only pass")
H2D_GBPS_DEFAULT = 49.3
SSD_GBPS_DEFAULT = 7.3


def transport_rates() -> Tuple[float, float]:
    """``(h2d_gbps, ssd_gbps)`` the pushdown decision runs on."""
    h2d = float(config.get("pushdown_h2d_gbps"))
    ssd = float(config.get("pushdown_ssd_gbps"))
    if not h2d:
        from ..hbm.staging import h2d_meter
        h2d = h2d_meter.observed_gbps() or H2D_GBPS_DEFAULT
    return h2d, ssd or SSD_GBPS_DEFAULT


@dataclass(frozen=True)
class PushdownDecision:
    """Where a packed scan expands, and the wire-byte prediction EXPLAIN
    reports."""

    mode: str                    # "chip" | "host" | "raw"
    wire_bytes: int              # predicted bytes crossing host->device
    logical_bytes: int           # bytes the query logically consumes
    per_column: Tuple[tuple, ...]   # (col, codec, ratio, "chip"|"host"|"raw")
    reason: str

    def explain(self) -> str:
        cols = ", ".join(
            f"col{c}={where}({codec}" +
            (f" {ratio:.1f}x)" if codec != "raw" else ")")
            for c, codec, ratio, where in self.per_column)
        codecs = "+".join(sorted({codec for _c, codec, _r, _w
                                  in self.per_column})) or "none"
        return (f"pushdown {self.mode}: predicted wire bytes: "
                f"{self.wire_bytes} ({self.logical_bytes} logical, "
                f"codec={codecs}); {cols}; {self.reason}")


def decide_pushdown(meta, need_cols: Optional[Sequence[int]] = None
                    ) -> PushdownDecision:
    """Per-column host/chip/raw decision for a packed sidecar (*meta*, a
    ``scan/colpack.py`` PackedMeta); *need_cols* restricts it to the
    columns the query reads.  ``pushdown=on`` forces chip, ``off`` raw;
    ``auto`` keys on the codec ratio against ``pushdown_chip_ratio`` and
    on which transport is the slower."""
    mode_cfg = config.get("pushdown")
    h2d, ssd = transport_rates()
    thresh = float(config.get("pushdown_chip_ratio"))
    need = set(range(len(meta.cols))) if need_cols is None \
        else set(need_cols)
    h2d_bound = ssd > h2d
    per_col = []
    for c, cm in enumerate(meta.cols):
        if c not in need:
            continue
        ratio = cm.ratio
        if mode_cfg == "on" or (ratio >= thresh and h2d_bound):
            where = "chip"
        elif ratio >= thresh:
            where = "host"
        else:
            where = "raw"
        per_col.append((c, cm.codec, round(ratio, 3), where))
    logical = 4 * meta.n_rows * len(per_col)
    # the file is one representation: page headers and unread columns'
    # regions ride along, so the wire prediction is whole packed pages
    wire_pages = meta.packed_bytes
    scan_ratio = logical / wire_pages if wire_pages else 1.0
    if mode_cfg == "off":
        mode, why = "raw", "pushdown=off"
    elif mode_cfg == "on":
        mode, why = "chip", "pushdown=on (forced)"
    elif not per_col:
        mode, why = "raw", "no packable columns in the projection"
    elif scan_ratio < thresh:
        mode, why = "raw", (f"whole-scan codec ratio {scan_ratio:.2f}x "
                            f"below chip threshold {thresh:.2f}x")
    elif h2d_bound:
        mode, why = "chip", (f"h2d is the slower leg ({h2d:.2f} vs SSD "
                             f"{ssd:.2f} GB/s): packed bytes cross the "
                             f"link, expand on the device")
    else:
        mode, why = "host", (f"SSD is the slower leg ({ssd:.2f} vs h2d "
                             f"{h2d:.2f} GB/s): packed off disk, "
                             f"expanded on the host")
    return PushdownDecision(
        mode=mode,
        wire_bytes=int(wire_pages if mode != "raw"
                       else 4 * meta.n_rows * len(meta.cols)),
        logical_bytes=int(logical),
        per_column=tuple(per_col), reason=why)
